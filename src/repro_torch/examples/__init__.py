"""The reference's ``examples/`` servers as modules of the port.

``python -m repro_torch.examples.offload_serve`` (continuous serving, local
or lowered onto a device pool) and ``python -m repro_torch.examples.serve_batch``
(wave serving); each takes the reference's flags plus ``--device``.
"""
