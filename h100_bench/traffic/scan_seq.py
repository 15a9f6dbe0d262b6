"""Traffic kind ``scan_seq``: whole sequences through ``Processor.run_detection_foe``
on the scan engine (``--engine scan``): each call stages the whole sequence,
uploads it once and dispatches all its transitions ahead.

Everything but the engine is ``h100_bench.loop``'s. Traffic parameters:
``batch``, ``ring_extra`` (frames of the ring past one sequence),
``min_seqs``, ``check_seqs``, ``check_calls``, ``trace_seqs``, ``limits``;
the sequence length is the configuration's ``sequence_frames``.
"""
from __future__ import annotations

from h100_bench import loop
from h100_bench.loop import FLOW_SITES, TINY, pairs, release, traced, window  # noqa: F401


def prepare(run) -> None:
    loop.prepare(run, "scan")
