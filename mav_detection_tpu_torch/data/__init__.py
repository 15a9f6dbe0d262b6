from mav_detection_tpu_torch.data.dataset import Dataset
from mav_detection_tpu_torch.data.experiment import ExperimentDataset
from mav_detection_tpu_torch.data.midgard import MidgardDataset
from mav_detection_tpu_torch.data.sim_data import SimDataset
from mav_detection_tpu_torch.data.synthetic import SyntheticDataset, SyntheticParams
from mav_detection_tpu_torch.data.vis_drone import VisDroneDataset


def make_dataset(dataset_type, logger=None, sequence: str = "", device="cuda"):
    """Dataset factory (``mav_detection_tpu.data.make_dataset``). ``device``
    is the dataset's ``Dataset.device``: where the SkyUNet runs for frames
    without a sky mask and where ``SimDataset`` synthesises GT flow."""
    from mav_detection_tpu_torch.core.config import DatasetType

    if dataset_type == DatasetType.MIDGARD:
        return MidgardDataset(logger, sequence, device=device)
    if dataset_type == DatasetType.SIMULATION:
        return SimDataset(logger, sequence, device=device)
    if dataset_type == DatasetType.VIS_DRONE:
        return VisDroneDataset(logger, sequence, device=device)
    if dataset_type == DatasetType.EXPERIMENT:
        return ExperimentDataset(logger, sequence, device=device)
    if dataset_type == DatasetType.SYNTHETIC:
        ds = SyntheticDataset(logger, sequence)
        ds.device = device
        return ds
    raise ValueError(f"Invalid dataset type: {dataset_type}")


__all__ = [
    "Dataset",
    "SyntheticDataset",
    "SyntheticParams",
    "MidgardDataset",
    "SimDataset",
    "VisDroneDataset",
    "ExperimentDataset",
    "make_dataset",
]
