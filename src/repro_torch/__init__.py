"""BinarEye chip tier in PyTorch, with hand-written CUDA kernels for Hopper.

The counterpart of the JAX package ``repro``: the same module layout and
names, the same packed-word conventions, held bit-exact against it by
``tests/test_torch_*.py``.  Packed words are ``torch.int32`` tensors that
hold bit-identical views of ``repro``'s ``uint32`` words.  Entry points run
on the GPU unless the caller passes ``device="cpu"``; on the CPU every
kernel wrapper runs its plain PyTorch version.
"""
