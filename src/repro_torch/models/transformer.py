"""Model assembly (port of ``repro.models.transformer``): block dispatch, the
``Transformer`` module, its init, the forward pass and the training loss.

The reference stacks each pattern position's parameters over the repeating
units and scans them; here ``Transformer.blocks`` holds one ``Params`` node per
layer in layer order (unit u, pattern position j is layer ``u*unit_len + j``,
then the leftover layers) and the trunk runs them in a loop.
``convert.model_from_reference`` unstacks a reference parameter tree into
this layout and ``convert.params_to_reference`` restacks it.

Rematerialization is the reference's ``jax.checkpoint``: with ``remat`` each
unit of the trunk and each leftover block runs under
``torch.utils.checkpoint.checkpoint`` (recomputed in the backward pass), and
the loss recomputes each chunk's head product the same way.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import layers, moe, partition, rglru, rwkv


# ---------------------------------------------------------------------------
# block dispatch
# ---------------------------------------------------------------------------

def block_params_init(cfg, kind: str, gen, device: torch.device) -> dict:
    p = {"norm1": layers.norm_init(cfg, device)}
    if kind in ("attn", "attn_local", "moe"):
        p["attn"] = layers.attn_params_init(cfg, gen, device)
        p["norm2"] = layers.norm_init(cfg, device)
        if kind == "moe":
            p["moe"] = moe.moe_params_init(cfg, gen, device)
        else:
            p["ffn"] = layers.ffn_params_init(cfg, gen, device)
    elif kind == "rec":
        p["rec"] = rglru.rglru_params_init(cfg, gen, device)
        p["norm2"] = layers.norm_init(cfg, device)
        p["ffn"] = layers.ffn_params_init(cfg, gen, device)
    elif kind == "rwkv":
        p["tmix"] = rwkv.rwkv_params_init(cfg, gen, device)
        p["norm2"] = layers.norm_init(cfg, device)
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    return p


def block_apply(cfg, kind: str, p, x: torch.Tensor, angles) -> torch.Tensor:
    """Pre-norm residual block (training / prefill path, no carried state)."""
    h = layers.apply_norm(cfg, p["norm1"], x)
    if kind in ("attn", "attn_local", "moe"):
        window = cfg.window if kind == "attn_local" else 0
        x = x + layers.attn_apply(cfg, p["attn"], h, angles, window=window)
        h2 = layers.apply_norm(cfg, p["norm2"], x)
        if kind == "moe":
            x = x + moe.moe_apply(cfg, p["moe"], h2)
        else:
            x = x + layers.ffn_apply(p["ffn"], h2)
    elif kind == "rec":
        out, _ = rglru.rglru_block_apply(cfg, p["rec"], h)
        x = x + out
        h2 = layers.apply_norm(cfg, p["norm2"], x)
        x = x + layers.ffn_apply(p["ffn"], h2)
    else:  # rwkv
        out, _ = rwkv.time_mix_apply(cfg, p["tmix"], h)
        x = x + out
        h2 = layers.apply_norm(cfg, p["norm2"], x)
        out, _ = rwkv.channel_mix_apply(cfg, p["tmix"], h2)
        x = x + out
    return x


def layer_kinds(cfg) -> list[str]:
    """Block kind of every layer, in layer order."""
    return list(cfg.block_pattern) * cfg.num_units + list(cfg.leftover_pattern)


# ---------------------------------------------------------------------------
# the module
# ---------------------------------------------------------------------------

class Transformer(nn.Module):
    """The parameters of one model: ``embed`` (or the ``frontend_proj``
    stub), ``blocks`` in layer order, ``final_norm`` and ``lm_head`` (absent
    with tied embeddings). ``params`` is the tree of tensors with ``blocks``
    a list of per-layer dicts."""

    def __init__(self, cfg, params: dict):
        super().__init__()
        self.cfg = cfg
        self.kinds = layer_kinds(cfg)
        if len(params["blocks"]) != len(self.kinds):
            raise ValueError(f"{len(params['blocks'])} blocks for "
                             f"{len(self.kinds)} layers")
        stem = "embed" if cfg.frontend == "tokens" else "frontend_proj"
        self.register_parameter(stem, nn.Parameter(params[stem],
                                                   requires_grad=False))
        self.blocks = nn.ModuleList(layers.Params(b) for b in params["blocks"])
        self.final_norm = layers.Params(params["final_norm"])
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(params["lm_head"], requires_grad=False)

    @property
    def device(self) -> torch.device:
        return self.final_norm["scale"].device

    def forward(self, inputs: torch.Tensor, positions: torch.Tensor
                ) -> torch.Tensor:
        return forward(self, inputs, positions)


def _init_device(device) -> torch.device:
    """``None`` -> the card (raising without CUDA); "meta" builds shapes
    only (``launch.steps.params_shape``)."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


def init_params(cfg, generator: torch.Generator | None = None,
                device=None) -> Transformer:
    """A ``Transformer`` with the reference's parameter shapes, dtypes,
    distributions and constant leaves, drawn from ``generator`` (a generator
    on ``device``; None: one seeded with 0). On ``device="meta"`` nothing is
    allocated or drawn. Every leftover block is drawn from one generator
    state, as the reference draws each from one key."""
    dev = _init_device(device)
    gen = generator
    if gen is None and dev.type != "meta":
        gen = torch.Generator(device=dev).manual_seed(0)
    dt = layers.dtype_of(cfg.dtype)
    params = {}
    if cfg.frontend == "tokens":
        params["embed"] = layers.dense_init(gen, (cfg.vocab_size, cfg.d_model),
                                            dt, dev, scale=1.0)
    else:
        # modality frontend is a stub: inputs arrive as embeddings; a single
        # projection stands in for the (excluded) encoder output interface.
        params["frontend_proj"] = layers.dense_init(
            gen, (cfg.d_model, cfg.d_model), dt, dev)
    blocks = [block_params_init(cfg, kind, gen, dev)
              for kind in cfg.block_pattern * cfg.num_units]
    extra_state = gen.get_state() if gen is not None else None
    for kind in cfg.leftover_pattern:
        if gen is not None:
            gen.set_state(extra_state)
        blocks.append(block_params_init(cfg, kind, gen, dev))
    params["blocks"] = blocks
    params["final_norm"] = layers.norm_init(cfg, dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.dense_init(
            gen, (cfg.d_model, cfg.vocab_size), dt, dev)
    return Transformer(cfg, params)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def embed_inputs(model: Transformer, inputs: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) int -> embeddings (a gather: the reference's one-hot
    product at S=1 gives the same values), or float embeddings through the
    frontend stub projection. Adds sinusoidal absolute PE when configured."""
    cfg = model.cfg
    if cfg.frontend == "tokens":
        x = model.embed[inputs]
    else:
        x = inputs.to(layers.dtype_of(cfg.dtype)) @ model.frontend_proj
    if cfg.pos_emb == "sinusoidal":
        pos = positions if positions.ndim == 2 else positions[:, 0]
        x = x + layers.sinusoidal_embedding(pos, cfg.d_model).to(x.dtype)
    return x


def _remat(fn, *args):
    """fn(*args), recomputed in the backward pass instead of stored."""
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def trunk(model: Transformer, inputs: torch.Tensor, positions: torch.Tensor,
          *, remat: bool = False) -> torch.Tensor:
    """Embed + all blocks + final norm -> hidden states (B, S, d). With
    ``remat`` each unit of ``cfg.unit_len`` blocks and each leftover block
    is rematerialized (training)."""
    cfg = model.cfg
    x = partition.constrain_batch(embed_inputs(model, inputs, positions))
    angles = layers.positional_angles(cfg, positions)
    unit_layers = cfg.num_units * cfg.unit_len

    def run(lo: int, hi: int, x: torch.Tensor) -> torch.Tensor:
        for i in range(lo, hi):
            x = block_apply(cfg, model.kinds[i], model.blocks[i], x, angles)
        return x

    for lo in range(0, unit_layers, cfg.unit_len):
        hi = lo + cfg.unit_len
        x = _remat(run, lo, hi, x) if remat else run(lo, hi, x)
        x = partition.constrain_batch(x)
    for i in range(unit_layers, len(model.kinds)):
        x = _remat(run, i, i + 1, x) if remat else run(i, i + 1, x)
    return layers.apply_norm(cfg, model.final_norm, x)


def lm_head(model: Transformer) -> torch.Tensor:
    return model.embed.T if model.cfg.tie_embeddings else model.lm_head


def forward(model: Transformer, inputs: torch.Tensor,
            positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S, V)."""
    return trunk(model, inputs, positions) @ lm_head(model)


def _chunk_loss(xc: torch.Tensor, lc: torch.Tensor, head: torch.Tensor
                ) -> torch.Tensor:
    """Summed next-token cross entropy of one chunk: the head product, a
    float32 log-sum-exp and the label's logit; labels of -1 add nothing."""
    logits = (xc @ head).to(torch.float32)               # (B, cc, V) transient
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, lc.clamp(min=0).long()[..., None])[..., 0]
    return ((lse - ll) * (lc >= 0)).sum()


def loss_fn(model: Transformer, batch: dict, *, remat: bool = True,
            ce_chunk: int = 256) -> torch.Tensor:
    """Next-token cross entropy with a *chunked fused* head (big-vocab
    trick): the (B, S, V) logits are never materialized. Each sequence chunk
    of at most ``ce_chunk`` positions (shrunk to a divisor of S) computes the
    head product, log-softmax and gather, and is recomputed in the backward
    pass. Labels of -1 are masked; the softmax runs in float32."""
    x = trunk(model, batch["inputs"], batch["positions"], remat=remat)
    head = lm_head(model)
    labels = batch["labels"]
    s = x.shape[1]
    cc = min(ce_chunk, s)
    while s % cc:
        cc -= 1
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, cc):
        tot = tot + _remat(_chunk_loss, x[:, c0:c0 + cc],
                           labels[:, c0:c0 + cc], head)
    cnt = (labels >= 0).sum()
    return tot / cnt.clamp(min=1)
