"""musicgen-large [audio] — decoder-only over EnCodec tokens. [arXiv:2306.05284]

48L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=2048 (per codebook),
4 codebooks with the delay interleaving pattern applied by the data pipeline.
Per the spec carve-out, the EnCodec conv codec is NOT built; the backbone
consumes codec token ids directly.
"""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    arch_type="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    attention="full",
    act="gelu",
    glu=False,                    # plain MLP, as in the MusicGen decoder
    norm="layernorm",
    num_codebooks=4,
    source="arXiv:2306.05284",
)

REDUCED = CONFIG.replace(num_layers=2, d_model=256, num_heads=4,
                         num_kv_heads=4, d_ff=512, vocab_size=256,
                         num_codebooks=4)
