"""Llama-style transformer: the dense path and the (pipe, model) sharded path.

Counterpart of ``aggregathor_tpu/models/transformer.py`` (BASELINE config 5,
"Llama-class fine-tune with per-layer Krum").  The parameters are a plain
dict of tensors in the JAX package's names, shapes and layouts: products are
``x @ w`` with ``w`` of shape (in, out), and every leaf but
``NON_STACKED_LEAVES`` leads with (n_stages, layers_per_stage), so a weight
carried across from JAX is copied and never transposed
(``models.common.params_from_jax``).  A flattened gradient lays the leaves
out in JAX's pytree order of a dict, sorted keys (``core.flatten.FlatMap``
sorts them).

The same functions serve both paths: with no grid every axis is absent and
the math is plain single-device torch (``forward_dense``, ``loss_dense``,
vmappable: what the registered experiment runs under the flat engine); with
a ``parallel.mesh.DeviceGrid`` (``make_pipeline_loss``, the sharded engine)

- **TP**: SwiGLU MLP weights are column/row-sharded over the ``model``
  axis, Megatron-SP style: activations stay sequence-sharded between
  blocks, one tiled all-gather enters the MLP, one psum-scatter leaves it;
- **SP**: ring attention over the ``model`` axis: the K/V block rotates
  round the ring (``collectives.ppermute``) while an online softmax
  accumulates, so no rank holds the (S, S) scores or the whole sequence;
- **EP**: optional switch-routed MoE MLPs, the experts sharded over
  ``model``, the tokens travelling through one all-to-all each way;
- **PP**: GPipe microbatches over the ``pipe`` axis, M + P - 1 ticks, the
  activation passed along the ring by ``ppermute`` after each tick.

The collectives are ``parallel.collectives``: autograd Functions whose
backward is JAX's transpose, so the gradient of the local partial loss is
the exact gradient of the worker group's sum, as under JAX's ``shard_map``.
JAX's ``lax.cond(stage == ...)`` is uniform per rank: here a Python branch
on the rank's stage.  JAX's ``jax.checkpoint`` changes memory, not numbers:
it has no counterpart here (``torch.utils.checkpoint`` does not run under
the flat engine's ``torch.func.vmap``, and around a block that holds a
collective its recompute would run the collective again, out of step with
the other ranks), so the port's ``TransformerConfig`` has no ``remat``.
"""

import dataclasses
import math
import os

import torch
import torch.nn.functional as F

from ..parallel import collectives

_NEG = -1e30  # finite mask value: keeps the online softmax NaN-free

#: the grid's in-group axis names (``parallel.mesh``)
PIPE_AXIS, MODEL_AXIS = "pipe", "model"


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Static architecture hyper-parameters (Llama-style defaults)."""

    vocab_size: int = 256
    d_model: int = 64
    n_heads: int = 4
    n_layers: int = 4
    d_ff: int = 0            # 0 -> 4 * d_model
    n_experts: int = 0       # 0 -> dense SwiGLU MLP; > 0 -> switch MoE
    capacity_factor: float = 1.5
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: object = torch.float32

    @property
    def head_dim(self):
        return self.d_model // self.n_heads

    @property
    def ff_dim(self):
        return self.d_ff if self.d_ff else 4 * self.d_model


# --------------------------------------------------------------------------- #
#  Parameter construction                                                     #
# --------------------------------------------------------------------------- #


#: leaves with no leading (n_stages, layers/stage) stage dims; every other
#: leaf is stage-stacked
NON_STACKED_LEAVES = ("embed", "unembed", "final_norm")


def init_params(cfg, generator, n_stages=1):
    """The global parameter dict; stacked leaves lead with the stage dim.
    The draws are the port's own, from ``generator`` (a CPU
    ``torch.Generator``), in JAX's order of keys: N(0, 1) / sqrt(fan-in),
    norm scales 1."""
    if cfg.n_layers % n_stages != 0:
        raise ValueError("n_layers (%d) must divide into %d stages" % (cfg.n_layers, n_stages))
    lp = cfg.n_layers // n_stages
    d, h, dh, f, v, e = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.ff_dim, cfg.vocab_size, cfg.n_experts

    def dense(*shape):
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        return (torch.randn(shape, generator=generator, dtype=torch.float32) / math.sqrt(fan_in)).to(cfg.dtype)

    params = {
        "embed": dense(v, d),
        "unembed": dense(d, v),
        "final_norm": torch.ones((d,), dtype=cfg.dtype),
        "attn_norm": torch.ones((n_stages, lp, d), dtype=cfg.dtype),
        "mlp_norm": torch.ones((n_stages, lp, d), dtype=cfg.dtype),
        "wq": dense(n_stages, lp, d, h * dh),
        "wk": dense(n_stages, lp, d, h * dh),
        "wv": dense(n_stages, lp, d, h * dh),
        "wo": dense(n_stages, lp, h * dh, d),
    }
    if e:
        params.update({
            "router": dense(n_stages, lp, d, e),
            "we_gate": dense(n_stages, lp, e, d, f),
            "we_up": dense(n_stages, lp, e, d, f),
            "we_down": dense(n_stages, lp, e, f, d),
        })
    else:
        params.update({
            "w_gate": dense(n_stages, lp, d, f),
            "w_up": dense(n_stages, lp, d, f),
            "w_down": dense(n_stages, lp, f, d),
        })
    return params


def param_specs(cfg):
    """Each leaf's axis names, one entry a dim (None: not sharded), over the
    (worker, pipe, model) grid: workers replicate every parameter, ``pipe``
    shards the stage dim, the MLP weights (or the experts) shard over
    ``model``, everything else is replicated over ``model`` (the activations
    are sequence-sharded there).  JAX's ``PartitionSpec`` entries, as a
    tuple."""
    pa, ma = PIPE_AXIS, MODEL_AXIS
    specs = {
        "embed": (),
        "unembed": (),
        "final_norm": (),
        "attn_norm": (pa, None, None),
        "mlp_norm": (pa, None, None),
        "wq": (pa, None, None, None),
        "wk": (pa, None, None, None),
        "wv": (pa, None, None, None),
        "wo": (pa, None, None, None),
    }
    if cfg.n_experts:
        specs.update({
            "router": (pa, None, None, None),
            "we_gate": (pa, None, ma, None, None),
            "we_up": (pa, None, ma, None, None),
            "we_down": (pa, None, ma, None, None),
        })
    else:
        specs.update({
            "w_gate": (pa, None, None, ma),
            "w_up": (pa, None, None, ma),
            "w_down": (pa, None, ma, None),
        })
    return specs


# --------------------------------------------------------------------------- #
#  Building blocks                                                            #
# --------------------------------------------------------------------------- #


def rms_norm(x, scale, eps):
    """The variance in float32, the product cast back before the scale."""
    var = torch.mean(torch.square(x.to(torch.float32)), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * scale


def rope(x, positions, theta):
    """Rotary embedding on interleaved pairs ``(x[..., 0::2], x[..., 1::2])``
    (not the half-split ``rotate_half``); ``positions`` are global, so the
    sequence-parallel blocks stay aligned."""
    b, s, h, dh = x.shape
    freqs = torch.exp(-torch.arange(0, dh, 2, dtype=torch.float32, device=x.device) * (math.log(theta) / dh))
    angles = positions.to(torch.float32)[:, None] * freqs[None, :]  # (s, dh/2)
    cos, sin = torch.cos(angles)[None, :, None, :], torch.sin(angles)[None, :, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    rx1 = x1 * cos - x2 * sin
    rx2 = x1 * sin + x2 * cos
    return torch.stack([rx1, rx2], dim=-1).reshape(b, s, h, dh).to(x.dtype)


def _attend_block(q, k, v, q_pos, k_pos, num, den, mx):
    """One online-softmax accumulation step of blockwise causal attention;
    masked scores are the finite ``_NEG``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale
    mask = q_pos[:, None] >= k_pos[None, :]
    scores = torch.where(mask[None, None], scores, _NEG)
    new_mx = torch.maximum(mx, scores.amax(dim=-1))
    corr = torch.exp(mx - new_mx)
    p = torch.exp(scores - new_mx[..., None])
    num = num * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v.to(torch.float32))
    den = den * corr + p.sum(dim=-1)
    return num, den, new_mx


def ring_attention(q, k, v, positions, axis):
    """Blockwise causal attention; the K/V block rides a ``ppermute`` ring
    over ``axis`` (a WorkerAxis, or None: the whole sequence here).

    q/k/v: (B, S_blk, H, Dh), sequence-sharded over ``axis``;
    ``positions``: the (S_blk,) global positions of the local block.  The
    block holding the diagonal comes first (i = 0), as in JAX, so the
    correction ``exp(mx - new_mx)`` wipes the weight a fully masked block
    left.  The K/V pair crosses the ring as one tensor, T - 1 times (JAX's
    T-th rotation is discarded).  Returns (B, S_blk, H, Dh)."""
    b, sb, h, dh = q.shape
    num = torch.zeros((b, h, sb, dh), dtype=torch.float32, device=q.device)
    den = torch.zeros((b, h, sb), dtype=torch.float32, device=q.device)
    mx = torch.full((b, h, sb), _NEG, dtype=torch.float32, device=q.device)
    t_size = 1 if axis is None else axis.size
    if t_size == 1:
        num, den, mx = _attend_block(q, k, v, positions, positions, num, den, mx)
    else:
        my = axis.rank
        kv = torch.stack([k, v])
        for i in range(t_size):
            src = (my - i) % t_size  # who produced the K/V block held now
            k_pos = src * sb + torch.arange(sb, device=q.device)
            num, den, mx = _attend_block(q, kv[0], kv[1], positions, k_pos, num, den, mx)
            if i < t_size - 1:
                kv = collectives.ppermute(kv, axis, 1)
    out = num / torch.clamp_min(den[..., None], 1e-30)
    return out.permute(0, 2, 1, 3).to(q.dtype)  # (B, S_blk, H, Dh)


def attention_block(x, positions, wq, wk, wv, wo, cfg, axis):
    b, sb, _ = x.shape
    h, dh = cfg.n_heads, cfg.head_dim
    q = rope((x @ wq).reshape(b, sb, h, dh), positions, cfg.rope_theta)
    k = rope((x @ wk).reshape(b, sb, h, dh), positions, cfg.rope_theta)
    v = (x @ wv).reshape(b, sb, h, dh)
    out = ring_attention(q, k, v, positions, axis)
    return out.reshape(b, sb, h * dh) @ wo


def mlp_block(x, w_gate, w_up, w_down, axis):
    """Megatron-SP SwiGLU: gather the sequence, the TP products (a partial
    sum over the local F columns), psum-scatter the sequence."""
    if axis is not None and axis.size > 1:
        xg = collectives.all_gather_tiled(x, axis, 1)  # (B, S, D)
        y = (F.silu(xg @ w_gate) * (xg @ w_up)) @ w_down
        return collectives.psum_scatter_tiled(y, axis, 1)
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def moe_block(x, router, we_gate, we_up, we_down, cfg, axis):
    """Switch (top-1) MoE with the experts sharded over ``axis``.

    Each rank routes its own S/T tokens: the capacity is counted from the
    local token count, ``max(1, ceil(N cf / E))``, and the aux loss is this
    shard's.  Ties in the expert argmax go to the lower index; the dispatch
    positions are a float32 cumsum (exact below 2^24); the one-hot codes
    compare with an ``arange`` (vmappable).  The tokens go to the expert
    owners through one all-to-all and come back the same way.  Returns
    (output, load-balancing aux loss)."""
    b, sb, d = x.shape
    tokens = x.reshape(b * sb, d)
    n = tokens.shape[0]
    e = cfg.n_experts
    t_size = 1 if axis is None else axis.size
    el = e // t_size  # local experts a rank

    logits = tokens @ router  # (N, E)
    gates = torch.softmax(logits.to(torch.float32), dim=-1)
    expert = torch.argmax(gates, dim=-1)
    gate = torch.amax(gates, dim=-1)
    experts = torch.arange(e, device=x.device)
    onehot = (expert[:, None] == experts[None, :]).to(torch.float32)  # (N, E)

    # load-balancing aux (Switch Transformer): E * <fraction routed> . <mean gate>
    aux = e * torch.mean(torch.mean(onehot, dim=0) * torch.mean(gates, dim=0))

    cap = max(1, int(math.ceil(n * cfg.capacity_factor / e)))
    pos = torch.einsum("ne,ne->n", torch.cumsum(onehot, dim=0) - 1.0, onehot).to(torch.int32)
    keep = (pos < cap).to(torch.float32)
    dispatch = onehot * keep[:, None]  # (N, E): the tokens that fit
    slots = torch.arange(cap, device=x.device, dtype=torch.int32)
    disp_tensor = dispatch[..., None] * (pos[:, None] == slots[None, :]).to(torch.float32)[:, None, :]  # (N, E, C)

    expert_in = torch.einsum("nec,nd->ecd", disp_tensor, tokens.to(torch.float32))  # (E, C, D)
    if t_size > 1:
        ei = collectives.all_to_all(expert_in.reshape(t_size, el, cap, d), axis)
        expert_in = ei.permute(1, 0, 2, 3).reshape(el, t_size * cap, d)
    # float32 codes meet the weights' dtype as JAX promotes them
    expert_in = expert_in.to(torch.promote_types(expert_in.dtype, we_gate.dtype))
    h = F.silu(torch.einsum("ecd,edf->ecf", expert_in, we_gate)) * torch.einsum("ecd,edf->ecf", expert_in, we_up)
    expert_out = torch.einsum("ecf,efd->ecd", h, we_down)  # (El, T C, D)
    if t_size > 1:
        eo = expert_out.reshape(el, t_size, cap, d).permute(1, 0, 2, 3)  # (T, El, C, D)
        expert_out = collectives.all_to_all(eo, axis).reshape(e, cap, d)
    combine = disp_tensor * gate[:, None, None]
    out = torch.einsum("nec,ecd->nd", combine.to(expert_out.dtype), expert_out)
    return out.reshape(b, sb, d).to(x.dtype), aux.to(torch.float32)


def _layer(x, positions, lp_params, cfg, axis):
    """One pre-norm transformer block on a (B, S_blk, D) activation."""
    x = x + attention_block(rms_norm(x, lp_params["attn_norm"], cfg.norm_eps), positions, lp_params["wq"],
                            lp_params["wk"], lp_params["wv"], lp_params["wo"], cfg, axis)
    h = rms_norm(x, lp_params["mlp_norm"], cfg.norm_eps)
    if cfg.n_experts:
        y, aux = moe_block(h, lp_params["router"], lp_params["we_gate"], lp_params["we_up"], lp_params["we_down"],
                           cfg, axis)
    else:
        y, aux = mlp_block(h, lp_params["w_gate"], lp_params["w_up"], lp_params["w_down"], axis), None
    return x + y, aux


def stage_forward(x, positions, stage_params, cfg, axis):
    """This stage's layers, in order, on one microbatch: ``(x, aux)``, aux
    the float32 sum of the layers' MoE aux losses (0 without experts)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in range(next(iter(stage_params.values())).shape[0]):
        x, a = _layer(x, positions, {k: v[layer] for k, v in stage_params.items()}, cfg, axis)
        if a is not None:
            aux = aux + a
    return x, aux


# --------------------------------------------------------------------------- #
#  Dense (collective-free) path: the flat engine, the tests                   #
# --------------------------------------------------------------------------- #


def merge_stages(params):
    """The stage dim of a stage-stacked dict collapsed: (S, L/S, ...) ->
    (1, L, ...), the ``n_stages=1`` layout of the dense path (JAX
    ``sharded_to_dense_params``)."""
    out = {}
    for name, leaf in params.items():
        if name in NON_STACKED_LEAVES:
            out[name] = leaf
        else:
            out[name] = leaf.reshape((1, leaf.shape[0] * leaf.shape[1]) + tuple(leaf.shape[2:]))
    return out


def _stage_params(params):
    return {k: v[0] for k, v in params.items() if k not in NON_STACKED_LEAVES}


def _log_probs_at(logits, targets):
    """float32 log-softmax of ``logits`` at ``targets``."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return torch.gather(logp, -1, targets.long()[..., None])[..., 0]


def forward_dense(params, tokens, cfg):
    """Plain single-device forward: (B, S) int tokens -> ((B, S, V) logits,
    aux).  Vmappable and collective-free: what the registered experiment
    runs under the flat engine."""
    x = F.embedding(tokens.long(), params["embed"])
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x, aux = stage_forward(x, positions, _stage_params(params), cfg, axis=None)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["unembed"], aux


def loss_dense(params, batch, cfg, aux_weight=1e-2):
    logits, aux = forward_dense(params, batch["tokens"], cfg)
    nll = -_log_probs_at(logits, batch["targets"])
    return torch.mean(nll) + aux_weight * aux


# --------------------------------------------------------------------------- #
#  Pipelined, fully sharded path: one rank of the grid                        #
# --------------------------------------------------------------------------- #


def make_pipeline_loss(cfg, n_stages, microbatches, aux_weight=1e-2):
    """``loss(params_local, batch_local, grid=None)`` for one rank of a
    (worker, pipe, model) grid (``parallel.mesh.DeviceGrid``; None: the
    one-rank grid).

    ``params_local`` are the rank's shards (stacked leaves lead with a
    stage dim of 1), ``batch_local`` one worker's ``tokens``/``targets`` of
    shape (B, S), B divisible into ``microbatches``, S over the model axis.
    The GPipe schedule is JAX's: M + P - 1 ticks, stage 0 embeds microbatch
    t, stage s holds microbatch t - s (a real one for s <= t < s + M; the
    others are bubbles, which this port skips: their outputs reach no loss,
    so the values are JAX's), the last stage adds the loss of microbatch
    t - (P - 1), and the activation moves along the pipe ring after every
    tick but the last (whose move JAX discards).

    Returns the **local partial** loss: its sum over the worker's
    (pipe, model) submesh is the batch loss (the token-mean cross-entropy
    plus the layer-summed, microbatch- and shard-mean aux).  Differentiate
    it as it is: the collectives' transposes give each rank the exact
    gradient of that sum (an in-loss psum would overcount it by the group
    size)."""

    def loss_fn(params, batch, grid=None):
        pipe = None if grid is None else grid.pipe
        model = None if grid is None else grid.model
        tokens, targets = batch["tokens"], batch["targets"]
        bsz, seq = tokens.shape
        t_size = 1 if model is None else model.size
        p_size = 1 if pipe is None else pipe.size
        stage = 0 if pipe is None else pipe.rank
        midx = 0 if model is None else model.rank
        if p_size != n_stages:
            raise ValueError("the pipeline loss was built for %d stages, the grid has %d" % (n_stages, p_size))
        if bsz % microbatches != 0:
            raise ValueError("batch %d not divisible into %d microbatches" % (bsz, microbatches))
        if seq % t_size != 0:
            raise ValueError("sequence %d not divisible over model axis %d" % (seq, t_size))
        mb = bsz // microbatches
        sb = seq // t_size
        device = params["embed"].device

        # the local sequence block of every microbatch (SP sharding)
        positions = midx * sb + torch.arange(sb, device=device)
        tok_mb = tokens.reshape(microbatches, mb, seq)[:, :, midx * sb:(midx + 1) * sb]
        tgt_mb = targets.reshape(microbatches, mb, seq)[:, :, midx * sb:(midx + 1) * sb]
        stage_params = _stage_params(params)
        n_ticks = microbatches + p_size - 1
        loss_sum = torch.zeros((), dtype=torch.float32, device=device)
        aux_sum = torch.zeros((), dtype=torch.float32, device=device)
        buf, dangling = None, []
        for t in range(n_ticks):
            real = stage <= t < stage + microbatches
            if not real:
                x = torch.zeros((mb, sb, cfg.d_model), dtype=cfg.dtype, device=device)
                if buf is not None:
                    dangling.append(buf)
            else:
                if stage == 0:
                    x = F.embedding(tok_mb[t].long(), params["embed"]).to(cfg.dtype)
                    if buf is not None:
                        dangling.append(buf)
                else:
                    x = buf
                x, aux = stage_forward(x, positions, stage_params, cfg, model)
                aux_sum = aux_sum + aux
                if stage == p_size - 1:
                    xf = rms_norm(x, params["final_norm"], cfg.norm_eps)
                    logits = (xf @ params["unembed"]).to(torch.float32)
                    loss_sum = loss_sum + torch.sum(-_log_probs_at(logits, tgt_mb[t - (p_size - 1)]))
            buf = collectives.ppermute(x, pipe, 1) if p_size > 1 and t < n_ticks - 1 else None
        loss = loss_sum / (bsz * seq) + aux_weight * aux_sum / (microbatches * t_size)
        return collectives.anchor(loss, dangling)

    return loss_fn


# --------------------------------------------------------------------------- #
#  Registered experiment (synthetic corpus or the Python stdlib's bytes)       #
# --------------------------------------------------------------------------- #


def synthetic_corpus(vocab_size, length, seed=0):
    """Deterministic order-2 Markov byte stream (a copy of JAX
    ``transformer.py:466-482``): learnable structure with no dataset."""
    import numpy as np

    rng = np.random.default_rng(seed)
    trans = rng.dirichlet(np.full(vocab_size, 0.1), size=(vocab_size, vocab_size))
    cum = trans.cumsum(axis=-1)
    uniforms = rng.random(length)
    out = np.empty(length, np.int32)
    a = b = 0
    for i in range(length):
        c = min(int(np.searchsorted(cum[a, b], uniforms[i])), vocab_size - 1)
        out[i] = c
        a, b = b, c
    return out


def code_corpus(max_bytes=4_000_000):
    """Real byte-level text read locally (a copy of JAX
    ``transformer.py:485-516``): the Python standard library's own sources,
    concatenated in sorted order; None when the stdlib holds less than
    asked and under 65536 bytes."""
    import glob as _glob
    import sysconfig

    stdlib = sysconfig.get_paths()["stdlib"]
    chunks, total = [], 0
    for path in sorted(_glob.glob(os.path.join(stdlib, "*.py"))):
        try:
            with open(path, "rb") as handle:
                data = handle.read()
        except OSError:
            continue
        chunks.append(data)
        total += len(data)
        if total >= max_bytes:
            break
    blob = b"".join(chunks)[:max_bytes]
    if len(blob) < max_bytes and len(blob) < 65536:
        return None
    import numpy as np

    return np.frombuffer(blob, np.uint8).astype(np.int32)


from . import Experiment, register  # noqa: E402  (after module-level helpers)
from ..utils import parse_keyval  # noqa: E402


class TransformerExperiment(Experiment):
    """Next-token LM (JAX ``TransformerExperiment``, the same arguments and
    defaults).

    Args (key:value): vocab:64 d-model:64 heads:4 layers:4 d-ff:0 experts:0
    seq:128 batch-size:16 corpus:65536 corpus-source:markov.

    ``corpus-source:code`` trains on real bytes (``code_corpus``) with a
    held-out final 10% eval split and byte vocab 256; the default
    ``markov`` keeps the synthetic stream, its eval windows drawn from the
    same stream.  ``.synthetic`` says which.  The sharded hooks
    (``sharded_init``, ``sharded_specs``, ``sharded_loss``) serve the
    runner's ``--mesh``."""

    def __init__(self, args):
        super().__init__(args)
        kv = parse_keyval(args, defaults={
            "vocab": 64, "d-model": 64, "heads": 4, "layers": 4, "d-ff": 0, "experts": 0, "seq": 128,
            "batch-size": 16, "corpus": 65536, "corpus-source": "markov",
        })
        source = str(kv["corpus-source"])
        if source == "code":
            # real bytes need the full byte vocab whatever the default
            kv["vocab"] = max(int(kv["vocab"]), 256)
        self.cfg = TransformerConfig(vocab_size=int(kv["vocab"]), d_model=int(kv["d-model"]),
                                     n_heads=int(kv["heads"]), n_layers=int(kv["layers"]), d_ff=int(kv["d-ff"]),
                                     n_experts=int(kv["experts"]))
        self.seq = int(kv["seq"])
        self.batch_size = int(kv["batch-size"])
        corpus = code_corpus(int(kv["corpus"])) if source == "code" else None
        if corpus is not None:
            # held-out eval: the last 10% of the real text is never trained on
            split = int(len(corpus) * 0.9)
            self.corpus, self.eval_corpus = corpus[:split], corpus[split:]
            self.synthetic = False
            if self.seq + 1 > len(self.eval_corpus):
                from ..utils import UserException

                raise UserException(
                    "seq:%d needs at least %d eval bytes but the held-out split of corpus:%s has %d — raise corpus "
                    "or lower seq" % (self.seq, self.seq + 1, kv["corpus"], len(self.eval_corpus)))
        else:
            if source == "code":
                from ..utils import warning

                warning("corpus-source:code unavailable (stdlib too small); using the synthetic Markov stream")
            self.corpus = synthetic_corpus(self.cfg.vocab_size, int(kv["corpus"]))
            self.eval_corpus = self.corpus
            self.synthetic = True

    supports_sharded = True

    def init(self, seed):
        return init_params(self.cfg, torch.Generator().manual_seed(int(seed)), n_stages=1)

    # --- the sharded engine's hooks (cli/runner.py --mesh W,PP,TP) ---
    def sharded_init(self, n_stages):
        return lambda seed: init_params(self.cfg, torch.Generator().manual_seed(int(seed)), n_stages=n_stages)

    def sharded_specs(self):
        return param_specs(self.cfg)

    def sharded_loss(self, n_stages, microbatches):
        return make_pipeline_loss(self.cfg, n_stages=n_stages, microbatches=microbatches)

    def sharded_to_dense_params(self, params):
        """The stage dim of a stage-stacked dict collapsed (``merge_stages``)."""
        return merge_stages(params)

    def loss(self, params, batch):
        return loss_dense(params, batch, self.cfg)

    def metrics(self, params, batch):
        logits, _ = forward_dense(params, batch["tokens"], self.cfg)
        targets = batch["targets"]
        hits = torch.sum(torch.argmax(logits, dim=-1) == targets.long()).to(torch.float32)
        count = torch.full((), float(targets.numel()), dtype=torch.float32, device=logits.device)
        nll = -_log_probs_at(logits, targets)
        return {"accuracy": (hits, count), "nll": (torch.sum(nll), count)}

    def _sample(self, rng, nb_workers, batch_size, corpus=None):
        return _windows(corpus if corpus is not None else self.corpus, self.seq, rng, nb_workers, batch_size)

    def make_train_iterator(self, nb_workers, seed=0):
        """Worker-major windows of the train corpus, drawn from a numpy
        ``default_rng(seed)`` as JAX's generator draws them."""
        return WindowIterator(self.corpus, self.seq, nb_workers, self.batch_size, seed)

    def make_eval_iterator(self, nb_workers):
        import numpy as np

        rng = np.random.default_rng(10**9)
        for _ in range(4):
            yield self._sample(rng, nb_workers, self.batch_size, corpus=self.eval_corpus)


def _windows(corpus, seq, rng, nb_workers, batch_size):
    """One (nb_workers, batch_size) batch of ``seq + 1``-token windows at
    uniform starts: ``tokens`` and the ``targets`` one token on."""
    import numpy as np

    starts = rng.integers(0, len(corpus) - seq - 1, size=(nb_workers, batch_size))
    window = corpus[starts[..., None] + np.arange(seq + 1)]
    return {"tokens": window[..., :-1], "targets": window[..., 1:]}


class WindowIterator:
    """The infinite train stream of ``TransformerExperiment`` with the
    runner's iterator surface: ``next``, ``skip(k)`` (the resume
    fast-forward: the same draws, discarded), ``alloc_chunk`` and
    ``next_many(k, out=)`` (the input pipeline's chunks, bit-identical to k
    calls of ``next``)."""

    def __init__(self, corpus, seq, nb_workers, batch_size, seed=0):
        import numpy as np

        self.corpus, self.seq = corpus, int(seq)
        self.nb_workers, self.batch_size = int(nb_workers), int(batch_size)
        self.rng = np.random.default_rng(seed)

    def __iter__(self):
        return self

    def __next__(self):
        return _windows(self.corpus, self.seq, self.rng, self.nb_workers, self.batch_size)

    def skip(self, k):
        for _ in range(int(k)):
            next(self)

    def alloc_chunk(self, k, pin_memory=False):
        import numpy as np

        shape = (int(k), self.nb_workers, self.batch_size, self.seq)
        if not pin_memory:
            return {name: np.empty(shape, self.corpus.dtype) for name in ("tokens", "targets")}
        dtype = torch.from_numpy(np.empty(0, self.corpus.dtype)).dtype
        return {name: torch.empty(shape, dtype=dtype, pin_memory=True).numpy() for name in ("tokens", "targets")}

    def next_many(self, k, out=None):
        if out is None:
            out = self.alloc_chunk(k)
        for step in range(int(k)):
            batch = next(self)
            for name, value in batch.items():
                out[name][step] = value
        return out


register("transformer", TransformerExperiment)
