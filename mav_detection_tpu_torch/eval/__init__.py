from mav_detection_tpu_torch.eval.validator import Validator

__all__ = ["Validator"]
