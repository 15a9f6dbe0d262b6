"""Probe entry points: the reference's TPU probes under ``tools/``, ported.

    python -m mav_detection_tpu_torch.tools.gather_probe [--rows 64 --cols 768 --S 8]
    python -m mav_detection_tpu_torch.tools.chain_probe [--S 8 --th 24 --tw 752]
    python -m mav_detection_tpu_torch.tools.batch_overhead_probe [H W]

Each takes the reference tool's flags and defaults plus ``--device`` (the
card by default; ``cpu`` runs the plain versions and times them on the host
clock), prints what the tool prints plus the bytes bound and the share of
it, and returns its numbers as a dict from ``main(argv, device=None)``.
Their timing and the H100's peak rates are ``utils/timing.py``'s.
"""
