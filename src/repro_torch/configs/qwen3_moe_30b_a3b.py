"""qwen3-moe-30b-a3b [moe] — 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B]

48L d_model=2048 32H (GQA kv=4) moe d_ff=768 vocab=151936.
On the 16x16 production grid the 128 experts are replicated r=2
(load-spreading layout, see core/layout.py).
"""
from repro_torch.common.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    arch_type="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=6144,                        # unused (all layers MoE); kept for ref
    vocab_size=151936,
    attention="full",
    act="silu",
    glu=True,
    norm="rmsnorm",
    rope_theta=1000000.0,
    moe=MoEConfig(
        num_experts=128,
        top_k=8,
        top_g=4,
        renorm_gates=True,
        d_ff_expert=768,
        capacity_factor=2.0,
        router="smile",
        lb_alpha=0.005,
        lb_beta=0.005,
        every_n_layers=1,
    ),
    source="hf:Qwen/Qwen3-30B-A3B",
)

REDUCED = CONFIG.replace(
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=2, head_dim=64,
    d_ff=512, vocab_size=512,
    moe=MoEConfig(num_experts=4, top_k=2, top_g=2, renorm_gates=True,
                  d_ff_expert=128, capacity_factor=4.0, router="smile",
                  lb_alpha=0.005, lb_beta=0.005, every_n_layers=1,
                  grid=(2, 4)),     # exercises the replication layout (r=2)
)
