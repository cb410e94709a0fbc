"""Hippo on PyTorch and CUDA: the port of ``src/repro`` to one NVIDIA H100.

The package mirrors the JAX package's module layout so every port module has
one reference module to match (``repro_torch.core.index`` ports
``repro.core.index``, and so on). It imports ``torch`` and never ``jax`` or
anything of ``repro``; the parity tests (``tests/test_torch_*.py``) are the
only code that imports both.

Device rule: entry points (``PagedTable`` device views,
``ShardedHippoIndex.create``, ``QueryEngine``) run on the card unless the
caller asks for the CPU. ``device=None`` means ``"cuda"`` and raises when
CUDA is absent. Kernel wrappers dispatch on the tensor's device: a CPU tensor
takes the kernel's plain PyTorch version, a CUDA tensor launches the
hand-written kernel (``repro_torch/csrc``) or the call raises.

The main read path builds a sharded index over a paged key column, then
serves compact-mode ``QueryEngine`` batches over it. Beside it: the dense
and single-query paths, maintenance and the writer, learned summaries,
durability, the paper's comparison surfaces, placement, model serving, and
training (``optim``, ``data``, ``checkpointing.checkpoint``,
``launch.train``).
"""
