from mav_detection_tpu_torch.data.dataset import Dataset
from mav_detection_tpu_torch.data.synthetic import SyntheticDataset, SyntheticParams


def make_dataset(dataset_type, logger=None, sequence: str = ""):
    """Dataset factory (``mav_detection_tpu.data.make_dataset``). Only the
    synthetic fixture is ported; the MIDGARD, simulation, VisDrone and
    experiment readers raise until their slice lands."""
    from mav_detection_tpu_torch.core.config import DatasetType

    if dataset_type == DatasetType.SYNTHETIC:
        return SyntheticDataset(logger, sequence)
    if isinstance(dataset_type, DatasetType):
        raise NotImplementedError(
            f"dataset {dataset_type.name} is not ported yet; use synthetic")
    raise ValueError(f"Invalid dataset type: {dataset_type}")


__all__ = ["Dataset", "SyntheticDataset", "SyntheticParams", "make_dataset"]
