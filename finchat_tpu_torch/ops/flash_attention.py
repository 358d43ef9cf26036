"""Contiguous flash attention (K7): the one-shot forward and training.

``flash_attention(q [B, Sq, H, D], k [B, Sk, Hkv, D], v, *, q_offset,
kv_len, causal, scale)`` has the JAX package's signature and semantics
(``finchat_tpu/ops/flash_attention.py``): query row i of sequence b sits at
``q_offset[b] + i`` and sees keys at or before it (causal mode), keys at or
past ``kv_len[b]`` are masked, and GQA groups ``H // Hkv`` query heads on
one KV head without repeating K or V. It launches a hand-written forward
kernel (replacing the TPU kernel ``_flash_kernel``), which also writes the
per-row log-sum-exp, and it is differentiable: ``FlashAttentionFn``'s
backward launches a backward kernel, which rebuilds P from that
log-sum-exp (the flash-attention-2 form). The JAX package has no backward
for its kernel; its train step differentiates ``mha_reference``.

``flash_kernel_for``, a pure function of the call, picks the forward:

- ``flash_attention_sm90`` (``csrc/attention_bf16_sm90.cu``, the contiguous
  entry of the bf16 prefill body): causal calls at head_dim 128 whose query
  tiles hold 64 rows (group * tile tokens, ``paged_attention.tile_tokens``)
  — the training step and the one-shot forward of Llama-3. A TMA ring of
  K/V tiles and ``wgmma`` consumers, ``query_tiles_per_block`` query tiles a
  block.
- ``flash_attention`` (``csrc/flash_attention.cu``): every other call —
  ``causal=False`` (only tests ask for it), other head dims, fewer rows.

``flash_bwd_kernel_for``, under the same condition, picks the backward:

- ``flash_attention_bwd_sm90`` (``csrc/flash_attention_bwd_sm90.cu``): the
  calls the Hopper forward takes. A pre-pass (delta and the base-2 lse per
  query tile), a dK/dV body (a block per pair of 64-key tiles j and n - 1 - j
  of a KV head, two ``wgmma`` consumers taking the streamed query tiles in
  turn) and a dQ body (the forward's ring of K/V tiles, 64 keys a tile);
  no atomics.
- ``flash_attention_bwd`` (``csrc/flash_attention.cu``): every other call.

Nothing gives way to anything else: a CUDA tensor reaches the kernel the
rule names or raises. ``prepare_flash(..., kernel=name)`` and
``prepare_flash_bwd(..., kernel=name)`` build the launch of a named kernel
with no routing (``chip_smoke.py`` times both of each on the same inputs
with them).

``flash_attention_ref`` is the plain version (``mha_reference``'s math, plus
the log-sum-exp ``[B, H, Sq]`` fp32) and ``flash_attention_bwd_ref`` the
plain backward: ``P = exp(S - lse)``, ``delta = rowsum(dout * out)``,
``dS = P * (dP - delta)``, with P rounded to the value dtype before
``P^T dout`` as the forward rounds it before ``P V``. ``ops/dispatch.py``
picks the kernel for a CUDA tensor and ``flash_attention_ref`` (whose
autograd is plain PyTorch) for a CPU one.

Rows with no valid key output zeros in the kernel, as the JAX kernel does
(``acc / max(l, 1e-30)``), while the plain version, like ``mha_reference``,
averages over the masked keys; comparisons mask those rows. The plain
backward gives such rows no gradient, as the kernel does.
"""

from __future__ import annotations

import torch

from finchat_tpu_torch.ops import kernels
from finchat_tpu_torch.ops.kernels import check
from finchat_tpu_torch.ops.paged_attention import (
    SM90_ROWS,
    query_tiles_per_block,
    sm_count,
    tile_tokens,
)
from finchat_tpu_torch.ops.refs import attention_mask, gqa_repeat, masked_logits

HEAD_DIM = 128  # the kernels are built for Llama-3's head_dim
FORWARD_KERNELS = ("flash_attention_sm90", "flash_attention")
BACKWARD_KERNELS = ("flash_attention_bwd_sm90", "flash_attention_bwd")


def _descriptors(B: int, Sk: int, q_offset, kv_len, device) -> tuple[torch.Tensor, torch.Tensor]:
    """[B] int32 ``q_offset`` (default 0) and ``kv_len`` (default Sk)."""
    if q_offset is None:
        q_offset = torch.zeros((B,), dtype=torch.int32, device=device)
    else:
        q_offset = torch.broadcast_to(torch.as_tensor(q_offset, device=device), (B,))
        q_offset = q_offset.to(torch.int32)
    if kv_len is None:
        kv_len = torch.full((B,), Sk, dtype=torch.int32, device=device)
    else:
        kv_len = torch.as_tensor(kv_len, device=device).to(torch.int32)
    return q_offset.contiguous(), kv_len.contiguous()


def flash_attention_ref(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Sk, Hkv, D]
    v: torch.Tensor,
    *,
    q_offset: torch.Tensor | int | None = None,
    kv_len: torch.Tensor | None = None,
    causal: bool = True,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: ``(out [B, Sq, H, D] in q's dtype, lse [B, H, Sq]
    fp32)``, out exactly ``mha_reference``'s."""
    B, Sq, H, D = q.shape
    scale = scale if scale is not None else D ** -0.5
    mask = attention_mask(B, Sq, k.shape[1], q.device, causal=causal,
                          q_offset=0 if q_offset is None else q_offset, kv_len=kv_len)
    logits = masked_logits(q, k, mask, scale)
    lse = torch.logsumexp(logits, dim=-1)
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype).float(),
                       gqa_repeat(v, H).float())
    return out.to(q.dtype), lse


def flash_attention_bwd_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    out: torch.Tensor,  # [B, Sq, H, D] the forward's output
    lse: torch.Tensor,  # [B, H, Sq] fp32
    dout: torch.Tensor,  # [B, Sq, H, D]
    *,
    q_offset: torch.Tensor | int | None = None,
    kv_len: torch.Tensor | None = None,
    causal: bool = True,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain flash-attention-2 backward: ``(dq, dk, dv)`` in the inputs'
    dtypes, dk and dv summed over each KV head's group of query heads."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    mask = attention_mask(B, Sq, Sk, q.device, causal=causal,
                          q_offset=0 if q_offset is None else q_offset, kv_len=kv_len)
    p = torch.exp(masked_logits(q, k, mask, scale) - lse[..., None])
    p = torch.where(mask, torch.zeros_like(p), p)
    do32 = dout.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(v.dtype).float(), do32)
    dp = torch.einsum("bqhd,bkhd->bhqk", do32, gqa_repeat(v, H).float())
    delta = (do32 * out.float()).sum(-1).permute(0, 2, 1)  # [B, H, Sq]
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, gqa_repeat(k, H).float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    group = H // Hkv
    dk = dk.reshape(B, Sk, Hkv, group, D).sum(3)
    dv = dv.reshape(B, Sk, Hkv, group, D).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *extra: torch.Tensor) -> None:
    check(q.is_cuda, "the flash attention kernels run on CUDA tensors "
          "(flash_attention_ref is the plain version)")
    check(q.dim() == 4 and k.dim() == 4 and k.shape == v.shape
          and k.shape[0] == q.shape[0] and k.shape[3] == q.shape[3],
          f"want q [B, Sq, H, D] and k, v [B, Sk, Hkv, D], got {tuple(q.shape)}, "
          f"{tuple(k.shape)}, {tuple(v.shape)}")
    for t in (q, k, v, *extra):
        check(t.dtype == torch.bfloat16, "the flash attention kernels take bf16 tensors only")
        check(t.is_cuda and t.device == q.device and t.is_contiguous()
              and t.data_ptr() % 16 == 0,
              "flash attention tensors must be contiguous and 16-byte aligned on one "
              "CUDA device")
    check(q.shape[3] == HEAD_DIM,
          f"flash attention kernels are built for head_dim {HEAD_DIM}, got {q.shape[3]}")
    check(q.shape[2] % k.shape[2] == 0,
          f"heads {q.shape[2]} must be a multiple of kv heads {k.shape[2]}")
    check(q.shape[1] > 0 and k.shape[1] > 0, "empty sequence")


def _check_descriptors(q: torch.Tensor, q_offset: torch.Tensor, kv_len: torch.Tensor) -> None:
    for t in (q_offset, kv_len):
        check(t.dtype == torch.int32 and t.shape == (q.shape[0],) and t.is_contiguous()
              and t.device == q.device, "q_offset and kv_len must be [B] int32 on q's device")


def flash_kernel_for(causal: bool, group: int, head_dim: int, Sq: int, aligned: bool) -> str:
    """The forward kernel of a call: ``flash_attention_sm90`` for causal
    calls at head_dim 128 whose query tiles hold 64 rows (``group`` query
    heads a KV head times ``tile_tokens(group, Sq)``) over 16-byte aligned
    tensors; ``flash_attention`` for every other. No condition on Sk: the
    entry cuts kv_len at Sk, which keeps the next sequence's rows out of
    every sum."""
    if (causal and head_dim == HEAD_DIM and group * tile_tokens(group, Sq) == SM90_ROWS
            and aligned):
        return "flash_attention_sm90"
    return "flash_attention"


def prepare_flash(q, k, v, q_offset: torch.Tensor, kv_len: torch.Tensor, *, causal: bool,
                  scale: float, kernel: str | None = None) -> kernels.Prepared:
    """Check a forward call and build its launch, without launching: the
    kernel ``flash_kernel_for`` picks, or the forward named ``kernel`` (one
    of ``FORWARD_KERNELS``) with no routing. ``out`` is the output,
    ``aux`` the log-sum-exp [B, H, Sq] fp32. Raises on a tensor it does not
    take, a CPU one included."""
    _check(q, k, v)
    _check_descriptors(q, q_offset, kv_len)
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    group = H // Hkv
    rule = flash_kernel_for(causal, group, D, Sq, aligned=True)  # _check: 16-byte aligned
    name = rule if kernel is None else kernel
    check(name in FORWARD_KERNELS, f"{name} is not a flash attention forward kernel")
    extra = ()
    if name == "flash_attention_sm90":
        check(rule == name, "flash_attention_sm90 takes causal calls at head_dim 128 whose "
              f"query tiles hold 64 rows (got causal={causal}, group {group}, Sq {Sq})")
        extra = (tile_tokens(group, Sq), query_tiles_per_block(B, Sq, group, Hkv,
                                                               sm_count(q.device)))
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            q_offset.data_ptr(), kv_len.data_ptr(), B, Sq, Sk, H, Hkv, D, int(causal), *extra,
            float(scale))
    return kernels.Prepared(name, args, out, (q, k, v, q_offset, kv_len), aux=lse)


def flash_attention_fwd(q, k, v, q_offset: torch.Tensor, kv_len: torch.Tensor, *,
                        causal: bool, scale: float, kernel: str | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel ``prepare_flash`` picks (or ``kernel``): ``(out,
    lse)``. Raises on a tensor it does not take, a CPU one included."""
    call = prepare_flash(q, k, v, q_offset, kv_len, causal=causal, scale=scale, kernel=kernel)
    return call.launch(), call.aux


def flash_bwd_kernel_for(causal: bool, group: int, head_dim: int, Sq: int, aligned: bool) -> str:
    """The backward kernel of a call: ``flash_attention_bwd_sm90`` for the
    calls ``flash_kernel_for`` sends to the Hopper forward (causal, head_dim
    128, query tiles of 64 rows, 16-byte aligned), ``flash_attention_bwd``
    for every other."""
    if flash_kernel_for(causal, group, head_dim, Sq, aligned) == "flash_attention_sm90":
        return "flash_attention_bwd_sm90"
    return "flash_attention_bwd"


def prepare_flash_bwd(q, k, v, out, lse, dout, q_offset: torch.Tensor, kv_len: torch.Tensor,
                      *, causal: bool, scale: float, kernel: str | None = None
                      ) -> kernels.Prepared:
    """Check a backward call and build its launch, without launching: the
    kernel ``flash_bwd_kernel_for`` picks, or the backward named ``kernel``
    (one of ``BACKWARD_KERNELS``) with no routing. ``out`` is dq, ``aux``
    (dk, dv), all bf16; ``scratch`` what the kernel writes first (delta
    [B, H, Sq], or each 64-row query tile's base-2 lse and delta). One C
    entry, one launch count. Raises on a tensor it does not take, a CPU one
    included."""
    _check(q, k, v, out, dout)
    _check_descriptors(q, q_offset, kv_len)
    check(lse.dtype == torch.float32 and lse.is_contiguous()
          and lse.shape == (q.shape[0], q.shape[2], q.shape[1]), "lse must be [B, H, Sq] fp32")
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    group = H // Hkv
    rule = flash_bwd_kernel_for(causal, group, D, Sq, aligned=True)  # _check: 16-byte aligned
    name = rule if kernel is None else kernel
    check(name in BACKWARD_KERNELS, f"{name} is not a flash attention backward kernel")
    extra = ()
    if name == "flash_attention_bwd_sm90":
        check(rule == name, "flash_attention_bwd_sm90 takes causal calls at head_dim 128 whose "
              f"query tiles hold 64 rows (got causal={causal}, group {group}, Sq {Sq})")
        bq = tile_tokens(group, Sq)
        extra = (bq, query_tiles_per_block(B, Sq, group, Hkv, sm_count(q.device)))
        scratch = torch.empty((B, Hkv, -(-Sq // bq), 2, SM90_ROWS), dtype=torch.float32,
                              device=q.device)
    else:
        scratch = torch.empty_like(lse)  # rowsum(dout * out)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            q_offset.data_ptr(), kv_len.data_ptr(), B, Sq, Sk, H, Hkv, D, int(causal), *extra,
            float(scale))
    return kernels.Prepared(name, args, dq, (q, k, v, out, lse, dout, q_offset, kv_len),
                            scratch=scratch, aux=(dk, dv))


def flash_attention_bwd(q, k, v, out, lse, dout, q_offset: torch.Tensor, kv_len: torch.Tensor,
                        *, causal: bool, scale: float, kernel: str | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel ``prepare_flash_bwd`` picks (or ``kernel``):
    ``(dq, dk, dv)`` bf16. Raises on a tensor it does not take, a CPU one
    included."""
    call = prepare_flash_bwd(q, k, v, out, lse, dout, q_offset, kv_len, causal=causal,
                             scale=scale, kernel=kernel)
    return (call.launch(), *call.aux)


class FlashAttentionFn(torch.autograd.Function):
    """K7 with its gradient: the routed forward kernel saves ``out`` and
    ``lse``; the routed backward kernel recomputes P from them."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset, kv_len, causal: bool, scale: float):
        out, lse = flash_attention_fwd(q, k, v, q_offset, kv_len, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse, q_offset, kv_len)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, q_offset, kv_len = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout.contiguous(), q_offset, kv_len,
                                         causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q: torch.Tensor,  # [B, Sq, H, D] bf16, CUDA
    k: torch.Tensor,  # [B, Sk, Hkv, D]
    v: torch.Tensor,
    *,
    q_offset: torch.Tensor | int | None = None,  # [B] abs position of q[:, 0]
    kv_len: torch.Tensor | None = None,  # [B] valid KV length
    causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """Attention by the CUDA kernel, differentiable in q, k and v; returns
    [B, Sq, H, D] bf16. Raises on a tensor it does not take, a CPU one
    included."""
    q_offset, kv_len = _descriptors(q.shape[0], k.shape[1], q_offset, kv_len, q.device)
    scale = scale if scale is not None else q.shape[3] ** -0.5
    return FlashAttentionFn.apply(q, k, v, q_offset, kv_len, causal, float(scale))
