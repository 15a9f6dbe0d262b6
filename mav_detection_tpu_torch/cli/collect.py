"""Data-collection CLI of the port: ``python -m mav_detection_tpu_torch.cli.collect``.

Flies a ``settings.json`` collection (``--collection``) against AirSim over
RPC, or hermetically with ``--mock`` (the numpy mock simulator, at
``--image-size HxW``), and writes AirSim-layout sequences that
``--dataset simulation`` reads (``SIMDATA_PATH`` = the ``--data-dir``):

    python -m mav_detection_tpu_torch.cli.collect --collection foe-demo \
        --mock --image-size 1024x1920 --data-dir data --max-iterations 8
"""
from mav_detection_tpu_torch.sim.control import main

if __name__ == "__main__":
    main()
