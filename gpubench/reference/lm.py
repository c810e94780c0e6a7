"""Plain PyTorch reference of the benchmark's language models, in fp32 with
TF32 off: OLMo (arXiv:2402.00838) and Mamba-2 (arXiv:2405.21060).

It imports nothing of the program. It reads a parameter tree by the paths
the benchmark made it with (``layers.block0.attn.wq`` is (layers, d, H,
D_h), ``layers.block0.mamba.w_x`` (layers, d, d_inner), the tied table
``embed.table`` (rows, d)) and the widths from a configuration file's keys.
Every matrix product goes through a `Precision` (`FP32`, or `FP8`, the
control: fp8 training's usual recipe, each operand rounded to float8 e4m3
and each gradient in the backward pass to e5m2, one scale per tensor,
products summed in fp32).

Departures from the published descriptions, as the program has them: no
biases anywhere; OLMo's RoPE rotates the two halves of each head
(GPT-NeoX's layout); Mamba-2's input projection is five separate matrices
(z, x, B, C, dt) and its causal conv has no bias. The SSD is the chunked
algorithm of the Mamba-2 paper's minimal listing (`ssd_minimal`), exact for
any chunk length.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

F8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}   # largest finite values


@contextlib.contextmanager
def fp32_strict():
    """Full fp32 products: no TF32 in cuBLAS or cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def to_fp8(t: torch.Tensor, dtype: torch.dtype = torch.float8_e4m3fn) -> torch.Tensor:
    """`t` rounded to a float8 `dtype` under one scale for the whole tensor
    (its largest magnitude maps to the dtype's largest value), in fp32."""
    scale = t.detach().abs().amax().float().clamp_min(1e-30) / F8_MAX[dtype]
    return (t.float() / scale).to(dtype).float() * scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = to_fp8(a), to_fp8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = to_fp8(g, torch.float8_e5m2)
        ga = qg @ qb.transpose(-1, -2)
        if qb.dim() == 2 and qa.dim() > 2:
            gb = qa.reshape(-1, qa.shape[-1]).T @ qg.reshape(-1, qg.shape[-1])
        else:
            gb = qa.transpose(-1, -2) @ qg
        return ga, gb


class Precision:
    name = "fp32"

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return a.float() @ b.float()


class _Fp8(Precision):
    name = "fp8"

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _Fp8Matmul.apply(a.float(), b.float())


FP32 = Precision()
FP8 = _Fp8()


# --------------------------------------------------------------------------- #
# Pieces
# --------------------------------------------------------------------------- #
def layer_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def rms_norm(x: torch.Tensor, scale: torch.Tensor | None, eps: float) -> torch.Tensor:
    y = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
    return y if scale is None else y * scale.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, T, H, D) at positions 0 .. T-1, the halves rotated."""
    t, d = x.shape[1], x.shape[-1]
    half = d // 2
    inv_freq = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * inv_freq
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _layer(tree: dict, i: int) -> dict:
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def attention_block(p: dict, c: dict, x: torch.Tensor, pr: Precision) -> torch.Tensor:
    b, t, d = x.shape
    hq, hkv, dh = c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"]
    eps = c["norm_eps"]
    a = p["attn"]
    h = layer_norm(x, eps)
    q = pr.mm(h, a["wq"].reshape(d, hq * dh)).view(b, t, hq, dh)
    k = pr.mm(h, a["wk"].reshape(d, hkv * dh)).view(b, t, hkv, dh)
    v = pr.mm(h, a["wv"].reshape(d, hkv * dh)).view(b, t, hkv, dh)
    q, k = rope(q, c["rope_theta"]), rope(k, c["rope_theta"])
    g = hq // hkv
    q, k, v = (u.transpose(1, 2) for u in (q, k, v))
    k, v = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
    s = pr.mm(q, k.transpose(-1, -2)) * dh ** -0.5
    mask = torch.ones(t, t, dtype=torch.bool, device=x.device).triu(1)
    s = s.masked_fill(mask, float("-inf"))
    o = pr.mm(torch.softmax(s, dim=-1), v).transpose(1, 2).reshape(b, t, hq * dh)
    x = x + pr.mm(o, a["wo"].reshape(hq * dh, d))
    f = p["ffn"]
    h = layer_norm(x, eps)
    hid = F.silu(pr.mm(h, f["w_gate"])) * pr.mm(h, f["w_up"])
    return x + pr.mm(hid, f["w_down"])


def segsum(x: torch.Tensor) -> torch.Tensor:
    """Stable segment sums: out[..., i, j] = sum of x[..., j+1 .. i] for
    j <= i, -inf above the diagonal."""
    t = x.shape[-1]
    x = x[..., None].expand(*x.shape, t)
    low = torch.ones(t, t, dtype=torch.bool, device=x.device).tril(-1)
    x = x.masked_fill(~low, 0)
    out = torch.cumsum(x, dim=-2)
    return out.masked_fill(~torch.ones(t, t, dtype=torch.bool, device=x.device).tril(0),
                           float("-inf"))


def ssd_minimal(x, a, b, c, chunk: int, pr: Precision):
    """The Mamba-2 paper's chunked SSD. x (B, T, H, P) already scaled by dt,
    a = dt * A (B, T, H), b and c (B, T, H, N); T a multiple of `chunk`.
    Returns y (B, T, H, P)."""
    bs, t, h, p = x.shape
    n = b.shape[-1]
    nc = t // chunk
    x = x.reshape(bs, nc, chunk, h, p)
    b = b.reshape(bs, nc, chunk, h, n)
    c = c.reshape(bs, nc, chunk, h, n)
    a = a.reshape(bs, nc, chunk, h).permute(0, 3, 1, 2)          # (B, H, nc, L)
    a_cum = torch.cumsum(a, dim=-1)
    decay = torch.exp(segsum(a))                                  # (B, H, nc, L, L)
    # Within a chunk: (C_l . B_s) decay(l, s) x_s.
    cb = pr.mm(c.permute(0, 3, 1, 2, 4), b.permute(0, 3, 1, 4, 2))   # (B, H, nc, L, L)
    y_diag = pr.mm(cb * decay, x.permute(0, 3, 1, 2, 4))             # (B, H, nc, L, P)
    # Each chunk's state, then the states carried across chunks.
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)             # (B, H, nc, L)
    xs = x.permute(0, 3, 1, 4, 2) * decay_states[:, :, :, None, :]   # (B, H, nc, P, L)
    states = pr.mm(xs, b.permute(0, 3, 1, 2, 4))                  # (B, H, nc, P, N)
    states = torch.cat([torch.zeros_like(states[:, :, :1]), states], dim=2)
    decay_chunk = torch.exp(segsum(F.pad(a_cum[..., -1], (1, 0))))   # (B, H, nc+1, nc+1)
    new = pr.mm(decay_chunk, states.flatten(3)).view(*states.shape)  # (B, H, nc+1, P, N)
    states = new[:, :, :-1]
    y_off = pr.mm(c.permute(0, 3, 1, 2, 4), states.transpose(-1, -2))   # (B, H, nc, L, P)
    y_off = y_off * torch.exp(a_cum)[..., None]
    y = (y_diag + y_off).permute(0, 2, 3, 1, 4)                  # (B, nc, L, H, P)
    return y.reshape(bs, t, h, p)


def causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: y[t] = sum_i w[i] x[t - (K-1) + i]."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    t = x.shape[1]
    return sum(xp[:, i:i + t] * w[i].float() for i in range(k))


def mamba_block(p: dict, c: dict, x: torch.Tensor, pr: Precision) -> torch.Tensor:
    bs, t, d = x.shape
    din = c["expand"] * d
    hp = c["head_dim"]
    h = din // hp
    n, g, q = c["state_size"], c["n_groups"], c["chunk_size"]
    eps = c["norm_eps"]
    m = p["mamba"]
    u = rms_norm(x, p["norm1"]["scale"], eps)
    z = pr.mm(u, m["w_z"])
    xs = F.silu(causal_conv(pr.mm(u, m["w_x"]), m["conv_x"]))
    bp = F.silu(causal_conv(pr.mm(u, m["w_b"]), m["conv_b"]))
    cp = F.silu(causal_conv(pr.mm(u, m["w_c"]), m["conv_c"]))
    dt = F.softplus(pr.mm(u, m["w_dt"]) + m["dt_bias"].float())     # (B, T, H)
    a = -torch.exp(m["a_log"].float())
    xh = xs.view(bs, t, h, hp)
    rep = h // g
    bh = bp.view(bs, t, g, n).repeat_interleave(rep, dim=2)
    ch = cp.view(bs, t, g, n).repeat_interleave(rep, dim=2)
    pad = (-t) % q
    xd, ad = xh * dt[..., None], dt * a
    if pad:
        xd, ad = F.pad(xd, (0, 0, 0, 0, 0, pad)), F.pad(ad, (0, 0, 0, pad))
        bh, ch = F.pad(bh, (0, 0, 0, 0, 0, pad)), F.pad(ch, (0, 0, 0, 0, 0, pad))
    y = ssd_minimal(xd, ad, bh, ch, q, pr)[:, :t]
    y = (y + xh * m["d_skip"].float()[:, None]).reshape(bs, t, din)
    y = rms_norm(y * F.silu(z), m["norm_scale"], eps)
    return x + pr.mm(y, m["w_out"])


# --------------------------------------------------------------------------- #
# The model
# --------------------------------------------------------------------------- #
def hidden(params: dict, c: dict, ids: torch.Tensor, pr: Precision = FP32, *,
           remat: bool = False) -> torch.Tensor:
    """Final-normed hidden states (B, T, d) in fp32 of token ids (B, T).
    With `remat`, each layer keeps only its input for the backward pass and
    is computed again there."""
    x = params["embed"]["table"][ids].float()
    block = attention_block if c["block"] == "attention" else mamba_block
    stack = params["layers"]["block0"]
    for i in range(c["num_hidden_layers"]):
        if remat and torch.is_grad_enabled():
            x = checkpoint(block, _layer(stack, i), c, x, pr, use_reentrant=False)
        else:
            x = block(_layer(stack, i), c, x, pr)
    if c["block"] == "attention":
        return layer_norm(x, c["norm_eps"])
    return rms_norm(x, params["final_norm"]["scale"], c["norm_eps"])


def logits(params: dict, c: dict, h: torch.Tensor, pr: Precision = FP32) -> torch.Tensor:
    """fp32 logits over the vocabulary's rows of the tied table."""
    table = params["embed"]["table"][: c["vocab_size"]]
    return pr.mm(h, table.T)


def loss(params: dict, c: dict, inputs: torch.Tensor, labels: torch.Tensor,
         pr: Precision = FP32, chunk: int = 512, remat: bool = False) -> torch.Tensor:
    """Mean next-token cross-entropy of (B, T) inputs against labels, the
    logits taken `chunk` positions at a time."""
    h = hidden(params, c, inputs, pr, remat=remat)
    total = h.new_zeros(())
    for i in range(0, h.shape[1], chunk):
        lg = logits(params, c, h[:, i:i + chunk], pr)
        total = total + F.cross_entropy(lg.flatten(0, 1), labels[:, i:i + chunk].flatten(),
                                        reduction="sum")
    return total / labels.numel()
