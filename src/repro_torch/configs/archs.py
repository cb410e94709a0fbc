"""Assigned architecture configs (exact shapes from the assignment brief).

Sources are public literature; tags: [hf] = HuggingFace config,
[arXiv] = paper, [unverified] = assignment-provided.
"""
from repro_torch.configs.base import ModelConfig, register


@register("llama4-maverick-400b-a17b")
def llama4_maverick():
    # [hf:meta-llama/Llama-4; unverified] MoE interleaved every other layer,
    # 128 routed experts top-1 + shared expert, sigmoid router.
    return ModelConfig(
        name="llama4-maverick-400b-a17b", family="moe",
        num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
        d_ff=8192, vocab_size=202048,
        block_pattern=("attn", "moe"),
        num_experts=128, num_shared_experts=1, top_k=1, moe_d_ff=8192,
        router_act="sigmoid", rope_theta=500000.0,
    )


@register("qwen2-moe-a2.7b")
def qwen2_moe():
    # [hf:Qwen/Qwen1.5-MoE-A2.7B] every layer MoE: 60 routed top-4 + 4 shared.
    return ModelConfig(
        name="qwen2-moe-a2.7b", family="moe",
        num_layers=24, d_model=2048, num_heads=16, num_kv_heads=16,
        d_ff=1408, vocab_size=151936,
        block_pattern=("moe",),
        num_experts=60, num_shared_experts=4, top_k=4, moe_d_ff=1408,
    )


@register("qwen2-vl-7b")
def qwen2_vl():
    # [arXiv:2409.12191; hf] M-RoPE, dynamic resolution. Vision frontend is a
    # STUB: input_specs() provides precomputed patch embeddings.
    return ModelConfig(
        name="qwen2-vl-7b", family="vlm",
        num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
        d_ff=18944, vocab_size=152064,
        pos_emb="mrope", mrope_sections=(16, 24, 24), qkv_bias=True,
        frontend="patches", rope_theta=1000000.0,
    )


@register("musicgen-large")
def musicgen():
    # [arXiv:2306.05284; hf] decoder-only over EnCodec tokens; frontend STUB
    # provides frame embeddings; sinusoidal absolute positions.
    return ModelConfig(
        name="musicgen-large", family="audio",
        num_layers=48, d_model=2048, num_heads=32, num_kv_heads=32,
        d_ff=8192, vocab_size=2048,
        pos_emb="sinusoidal", norm="layernorm", frontend="frames",
    )


@register("recurrentgemma-9b")
def recurrentgemma():
    # [arXiv:2402.19427; unverified] Griffin: RG-LRU + local attention, 2:1.
    # 38 layers = 12 x (rec, rec, attn_local) + (rec, rec).
    return ModelConfig(
        name="recurrentgemma-9b", family="hybrid",
        num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,
        d_ff=12288, vocab_size=256000, head_dim=256,
        block_pattern=("rec", "rec", "attn_local"), window=2048,
    )


@register("yi-6b")
def yi():
    # [arXiv:2403.04652; hf] llama-arch GQA kv=4.
    return ModelConfig(
        name="yi-6b", family="dense",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=4,
        d_ff=11008, vocab_size=64000, rope_theta=5000000.0,
    )


@register("stablelm-3b")
def stablelm():
    # [hf:stabilityai/stablelm; unverified] MHA, LayerNorm, partial rotary 25%.
    return ModelConfig(
        name="stablelm-3b", family="dense",
        num_layers=32, d_model=2560, num_heads=32, num_kv_heads=32,
        d_ff=6912, vocab_size=50304,
        norm="layernorm", rope_fraction=0.25,
    )


@register("qwen2.5-3b")
def qwen25():
    # [hf:Qwen/Qwen2.5; hf] GQA kv=2, QKV bias.
    return ModelConfig(
        name="qwen2.5-3b", family="dense",
        num_layers=36, d_model=2048, num_heads=16, num_kv_heads=2,
        d_ff=11008, vocab_size=151936, qkv_bias=True, rope_theta=1000000.0,
    )


@register("smollm-360m")
def smollm():
    # [hf:HuggingFaceTB/SmolLM; hf] small llama-arch, GQA kv=5, head_dim 64.
    return ModelConfig(
        name="smollm-360m", family="dense",
        num_layers=32, d_model=960, num_heads=15, num_kv_heads=5,
        d_ff=2560, vocab_size=49152, head_dim=64,
    )


@register("rwkv6-3b")
def rwkv6():
    # [arXiv:2404.05892; hf] Finch — attention-free, data-dependent decay.
    return ModelConfig(
        name="rwkv6-3b", family="ssm",
        num_layers=32, d_model=2560, num_heads=0, num_kv_heads=0,
        d_ff=8960, vocab_size=65536, head_dim=64,
        block_pattern=("rwkv",), pos_emb="sinusoidal",
    )
