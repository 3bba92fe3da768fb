"""phi-3-vision-4.2b [vlm] — phi3-mini decoder + CLIP stub.
[hf:microsoft/Phi-3-vision-128k-instruct]

32L d_model=3072 32H (GQA kv=32) d_ff=8192 vocab=32064.
Per the spec carve-out the vision tower is a stub: ``input_specs`` provides
pre-computed CLIP patch embeddings (dim 1024); the projector + decoder are real.
"""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    arch_type="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    attention="full",
    act="silu",
    glu=True,
    norm="rmsnorm",
    rope_theta=10000.0,
    vision_tokens=576,            # 24x24 CLIP-L/14 patch grid
    vision_embed_dim=1024,
    source="hf:microsoft/Phi-3-vision-128k-instruct",
)

REDUCED = CONFIG.replace(num_layers=2, d_model=256, num_heads=4,
                         num_kv_heads=4, d_ff=512, vocab_size=512,
                         vision_tokens=16, vision_embed_dim=64)
