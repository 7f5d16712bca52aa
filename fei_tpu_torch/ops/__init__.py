from fei_tpu_torch.ops.rmsnorm import rms_norm
from fei_tpu_torch.ops.rope import compute_rope_freqs, apply_rope
from fei_tpu_torch.ops.attention import attention

__all__ = ["rms_norm", "compute_rope_freqs", "apply_rope", "attention"]
