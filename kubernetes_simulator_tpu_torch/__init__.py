"""kubernetes_simulator_tpu_torch — the PyTorch/CUDA port of
``kubernetes_simulator_tpu``.

The JAX package stays the reference; this package imports ``torch`` and
numpy, never ``jax`` and nothing of the JAX package (it keeps its own copy
of every host module it needs, each naming its counterpart). It replays
an encoded trace through the kube-scheduler Filter/Score/Permit semantics
on an NVIDIA H100, where the JAX package's device programs become
hand-written CUDA kernels (``csrc/``, bound in :mod:`.ops.kernels`).

Layers: models/ (object model, encodings, host state) → sim/ (synthetic
traces, wave packing, the replay engine) → ops/ (plain-PyTorch reference
chain and the kernel wrappers) → csrc/ (the kernels). Entry points run on
the card (``device="cuda"``) unless the caller asks for the CPU.
"""

__version__ = "0.1.0"

from .models.encode import encode  # noqa: F401
