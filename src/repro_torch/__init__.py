"""repro_torch — the paper's offload runtime ported to PyTorch and CUDA.

A second package beside the JAX reference ``repro``, with the same layout
(``core/…``, ``kernels/<name>/{ops,ref,<name>}.py``) so that every module has
a counterpart there.  It never imports ``jax`` or ``repro``.

Device rule: every entry point (``ClusterRuntime``/``RuntimeConfig``,
``DevicePool.virtual``/``from_config``, the BOTS ``run``/``verify``) runs on
the card (``device="cuda"``) unless the caller passes ``device="cpu"``, and
raises ``RuntimeError`` when CUDA is absent.  Nothing falls back to the CPU
by itself.
"""
