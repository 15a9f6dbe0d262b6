"""Traffic kind ``batch_seq``: whole sequences through ``Processor.run_detection_foe``
on the batch engine (the CLI's default): frames staged in batches on the
Processor's staging thread, flow and detection a batch at a time on the card.

Everything but the engine is ``h100_bench.loop``'s. Traffic parameters:
``batch``, ``ring_extra`` (frames of the ring past one sequence),
``min_seqs``, ``check_seqs``, ``check_calls``, ``trace_seqs``, ``limits``;
the sequence length is the configuration's ``sequence_frames``.
"""
from __future__ import annotations

from h100_bench import loop
from h100_bench.loop import FLOW_SITES, pairs, release, traced, window  # noqa: F401

TINY = dict(loop.TINY, batch=4)


def prepare(run) -> None:
    loop.prepare(run, "batch")
