"""Faults, and the comparison's control, planted in the program's timed
path: each batch the engine launches has its answers replaced where they
are produced, as ``SparseEngine._launch`` returns them.  For the tests
under ``bench/tests/`` and ``bench/control.py``; a run of the benchmark
plants nothing.

    control     the configuration's reference one precision lower in the
                program's place (``control()`` of its reference file);
    answer      one row of every answer altered by 1;
    half_batch  the batch's second half of slots left out (zeros);
    one_slot    one row of one slot's answer altered by 1, in every batch.
"""
from __future__ import annotations

import contextlib

import torch

KINDS = ("control", "answer", "half_batch", "one_slot")
ONE_SLOT = 37  # taken modulo the batch's real requests


@contextlib.contextmanager
def planted(kind: str, reference=None):
    """Within the block, every batch of every ``SparseEngine`` comes back
    with ``kind`` planted; ``reference`` is the configuration's reference
    module (for ``control``)."""
    from repro_torch.runtime.engine import SparseEngine

    if kind not in KINDS:
        raise ValueError(f"plant {kind!r} is not one of {KINDS}")
    launch = SparseEngine._launch
    arrays: dict = {}

    def csr(eng) -> tuple:
        # The matrix the harness handed the engine, as the harness made it.
        if id(eng) not in arrays:
            a = eng.a
            arrays[id(eng)] = tuple(torch.as_tensor(v).to(eng.device)
                                    for v in (a.indptr, a.indices, a.data))
        return arrays[id(eng)]

    def broken(self, bucket, reqs):
        ys, ok, event, poisoned = launch(self, bucket, reqs)
        ys = ys.clone()
        y2 = ys if ys.dim() == 2 else ys[:, None]
        take = len(reqs)
        if kind == "control":
            X = torch.stack([r.x for r in reqs], dim=1)
            y2[:, :take] = reference.control(*csr(self), X)
        elif kind == "answer":
            y2[17] += 1.0
        elif kind == "half_batch":
            y2[:, y2.shape[1] // 2:] = 0.0
        else:
            y2[17, ONE_SLOT % take] += 1.0
        if event is not None:
            event.record(torch.cuda.current_stream(self.device))
        return ys, ok, event, poisoned

    SparseEngine._launch = broken
    try:
        yield
    finally:
        SparseEngine._launch = launch
