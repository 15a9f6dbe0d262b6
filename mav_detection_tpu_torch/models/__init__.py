"""The learned nets of the port (``mav_detection_tpu.models``): the Flax
checkpoint reader, SkyUNet and RAFT inference. TinyYOLO is not ported yet."""
