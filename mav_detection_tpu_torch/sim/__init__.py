"""The simulator side (``mav_detection_tpu.sim``, copied; numpy only): the
client interface with its AirSim adapter and hermetic mock, the flight
configurations, and the data-collection choreography."""
from mav_detection_tpu_torch.sim.sim_config import FlightMode, Orientation, SimConfig
from mav_detection_tpu_torch.sim.client import AirSimClient, MockSimClient, Vector3
from mav_detection_tpu_torch.sim.control import SimDataCollector

__all__ = [
    "FlightMode",
    "Orientation",
    "SimConfig",
    "AirSimClient",
    "MockSimClient",
    "Vector3",
    "SimDataCollector",
]
