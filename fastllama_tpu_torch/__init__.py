"""fastllama_tpu_torch — the PyTorch/CUDA port of fastllama_tpu.

Group-quantized LLaMA serving on an NVIDIA Hopper card: plain PyTorch for
the tensor code, hand-written CUDA kernels (``csrc/``) for every kernel
the JAX package wrote in Pallas.  The package imports ``torch`` and never
``jax`` or ``fastllama_tpu``.

Device rule: entry points take ``device=None``, meaning ``"cuda"``; without
a card they raise unless the caller passes ``device="cpu"``, where every
kernel wrapper runs its plain PyTorch version.
"""
from fastllama_tpu_torch.config import EngineConfig, ModelConfig, QuantType
from fastllama_tpu_torch.runtime.engine import ChatSession, Engine
from fastllama_tpu_torch.runtime.spec_batching import SpecBatchedEngine
from fastllama_tpu_torch.runtime.speculative import SpeculativeEngine

__all__ = ["ChatSession", "Engine", "EngineConfig", "ModelConfig",
           "QuantType", "SpecBatchedEngine", "SpeculativeEngine"]
