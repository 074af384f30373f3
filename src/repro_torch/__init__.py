"""PyTorch / CUDA port of ``repro`` for NVIDIA Hopper (H100).

The JAX package ``src/repro/`` is the reference and stays unchanged; this
package mirrors its module names.  It imports ``torch`` and never ``jax``
or anything of ``repro``: the framework-neutral pieces it needs (tensor
networks, path search, plan schema, configs, request traces) are copied.

Implemented slice: planned serving of tt-lm-100m.  A DSE plan (committed
JSON under ``plans/``) installs into the model, ``launch.serve`` drives
``serve.engine.ServeEngine`` through ``models.lm`` and
``nn.linear.linear_apply``, and every planned TT projection runs in a CUDA
kernel written for ``sm_90a`` (``csrc/streaming_tt.cu``,
``csrc/tt_gemm.cu``).  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; on CPU tensors each kernel wrapper uses its plain
PyTorch version.
"""

__all__: list[str] = []
