"""PyTorch/CUDA port of the ``repro`` sparse-kernel serving stack.

The package mirrors ``repro``'s layout (``core``, ``data``, ``kernels``,
``tune``, ``runtime``, ``launch``) so each module's counterpart is easy to
find.  Host construction stays numpy; device code is torch on an explicit
``device=`` that defaults to ``"cuda"``.  The three main-path kernels (SELL
SpMV, column-slab SELL SpMV, BCSR SpMM) are hand-written CUDA C++ for
``sm_90a`` under ``kernels/csrc``; each has a plain torch version that runs
when its operands lie on the CPU.
"""
