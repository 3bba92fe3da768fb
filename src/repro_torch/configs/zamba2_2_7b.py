"""zamba2-2.7b [hybrid] — Mamba2 + shared attention blocks. [arXiv:2411.15242]

54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000, ssm_state=64.
Six Mamba2 layers per shared-attention invocation (shared parameters).
"""
from repro_torch.common.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    arch_type="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    attention="full",            # the shared attention block
    act="gelu",
    glu=True,
    norm="rmsnorm",
    ssm_layers_per_attn=6,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=128),
    source="arXiv:2411.15242",
)

REDUCED = CONFIG.replace(
    num_layers=4, d_model=256, num_heads=4, num_kv_heads=4, d_ff=512,
    vocab_size=512, ssm_layers_per_attn=2,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32, chunk=32))
