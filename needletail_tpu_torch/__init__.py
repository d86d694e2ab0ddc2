"""needletail_tpu_torch — the PyTorch/CUDA port of ``needletail_tpu``.

The JAX package ``needletail_tpu`` stays the reference; this package runs
its device paths with PyTorch on an NVIDIA Hopper GPU, through kernels
written by hand in CUDA C++ (``csrc/``), and is held bit for bit against
the JAX functions on the same inputs.  It imports no JAX: the host side
(parsers, framers, batch planes) is reused read-only from
``needletail_tpu``'s jax-free modules.

Layout mirrors the JAX package:
  * ``device.ops``       — wire transport: ``unwire``, ``unpack_codes``,
    ``expand_vrows``, ``resolve_vbits``, ``encode_2bit``.
  * ``device.kernels``   — the hand-written kernels and their plain
    PyTorch versions.
  * ``device.pipeline``  — ``hash_count_file``.
  * ``checkpoint``       — stream checkpoints, file-compatible with JAX's.
  * ``io.framing``       — the multi-worker framing front.
  * ``cli``              — ``python -m needletail_tpu_torch.cli hash-count``.
"""
