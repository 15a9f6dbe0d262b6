"""The learned nets of the port (``mav_detection_tpu.models``): the Flax
checkpoint reader, and SkyUNet, RAFT and TinyYOLO inference."""
