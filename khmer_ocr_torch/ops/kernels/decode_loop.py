"""The whole beam decode in one launch: CUDA kernel K3 (``csrc/decode_loop.cu``)
and its plain PyTorch version.

``fused_beam_decode(params, memory, memory_pad_mask, model_cfg, dec_cfg)``
returns the best tokens (B, max_len + 2), <sos> first: the contract of
``decode/beam.py::beam_decode``, with every one of the ``max_len`` steps run
(no early exit, which is provably safe, so the tokens are the same).
``return_scores=True`` also returns (B, K + 1) float32: the K running scores
after the last step, then the best completion's normalised score (NEG_INF if
there is none). A CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises. The kernel runs one thread-block cluster of one CTA
per attention head for each image (``geometry.k3_geometry``), the layer of
kernel K2 at every step, the self caches in shared memory where they fit.
Its storage type is ``memory.dtype`` (float32 or bfloat16, as the TPU
kernel's compute dtype): the weights, embeddings, memory K/V and self caches
in it, the layer rounding as K2 does, the head (its input rounded to the
storage type, float32 sums and bias) and the search in float32.

``should_use_megakernel`` is the gate ``beam_decode`` asks first. It is the JAX
package's semantic envelope: opt-in ``"1"`` (``DecodeConfig.mega_mode``, None
reads ``KHMER_OCR_MEGA_DECODE``), 2 <= K <= 4, vocab <= 128, Tm <= 128 and
max_len <= 64. The cap at K = 4 is the JAX kernel's too: its candidate block
has 16 columns (K * K <= 16). Under a tensor-parallel model group of more
than one rank the gate is shut: the kernel holds a whole decode in one
launch, with no point where a collective could run, so the batch takes the
host loop and K2's blocks (the tokens are the same either way).
"""

from __future__ import annotations

import ctypes
import os

import torch

from ...config import DecodeConfig, ModelConfig
from ...models.ocr_model import decode_hidden, init_decode_state, memory_kv, pack_decode_params
from . import build
from .decode_step import MATRIX_FIELDS, WEIGHT_FIELDS, _dot, decoder_layer_step_plain
from .geometry import MAX_CLUSTER, SMEM_LIMIT, k3_geometry, k3_smem_bytes, k3_vocab_cols

MIN_BEAM, MAX_BEAM, MAX_VOCAB, MAX_TM, MAX_LEN = 2, 4, 128, 128, 64


def should_use_megakernel(k: int, max_len: int, tm: int, vocab: int, mode: str | None = None,
                          model_ranks: int = 1) -> bool:
    """Whether ``beam_decode`` runs the whole decode in one launch
    (``model_ranks``: the size of the tensor-parallel model group)."""
    if mode is None:
        mode = os.environ.get("KHMER_OCR_MEGA_DECODE")
    return (mode == "1" and model_ranks == 1 and MIN_BEAM <= k <= MAX_BEAM and vocab <= MAX_VOCAB
            and tm <= MAX_TM and max_len <= MAX_LEN)


def fused_beam_decode_plain(params: dict, memory, memory_pad_mask, model_cfg: ModelConfig, dec_cfg: DecodeConfig,
                            return_scores: bool = False):
    """All ``max_len`` steps through the plain layer step and the beam search
    of decode/beam.py, with no early exit and no host sync; the head as the
    kernel's: the layer output rounded to the storage type, float32 sums
    and bias."""
    from ...decode.beam import beam_advance, beam_answer, beam_state  # decode/beam.py imports this module

    b = memory.shape[0]
    k, max_len = dec_cfg.beam_width, dec_cfg.max_len
    state = init_decode_state(params, memory, memory_pad_mask, model_cfg, lanes=k, cache_len=max_len)
    packed = pack_decode_params(params)
    cache_len = state["self_kv"][0][0].shape[1]
    st = beam_state(b, k, cache_len, dec_cfg, memory.device)
    out = packed["dec"]["out"]
    pos = st["pos"]
    for _ in range(max_len):
        x = decode_hidden(packed, state, st["tokens"].index_select(2, pos.reshape(1)).reshape(b * k), pos, model_cfg,
                          window=cache_len, lineage_local=st["lineage"].reshape(b * k, cache_len),
                          layer_step=decoder_layer_step_plain)
        logits = _dot(x.float(), out["w"]) + out["b"].float()
        beam_advance(st, torch.log_softmax(logits, dim=-1).reshape(b, k, -1), pos, dec_cfg)
        pos.add_(1)
    tokens = beam_answer(st)
    if return_scores:
        return tokens, torch.cat([st["scores"], st["best_done_score"][:, None]], dim=1)
    return tokens


def fused_beam_decode(params: dict, memory, memory_pad_mask, model_cfg: ModelConfig, dec_cfg: DecodeConfig,
                      return_scores: bool = False):
    if memory.device.type == "cpu":
        return fused_beam_decode_plain(params, memory, memory_pad_mask, model_cfg, dec_cfg, return_scores)
    return fused_beam_decode_kernel(params, memory, memory_pad_mask, model_cfg, dec_cfg, return_scores)


def resident_clusters(k: int, d: int, heads: int, f: int, max_len: int, vocab_cols: int, n_layers: int,
                      on_chip: bool, tc: int, dtype=torch.float32) -> int:
    """Clusters of one image each that the card holds at once for this K3
    launch in storage type ``dtype`` (the CUDA occupancy query): more images
    run in waves."""
    fn = build.load(build.library_name("decode_loop", dtype)).fused_beam_decode_resident_clusters
    fn.argtypes = [ctypes.c_int] * 9
    fn.restype = ctypes.c_int
    n = fn(k, d, heads, f, max_len, vocab_cols, n_layers, int(on_chip), tc)
    if n <= 0:
        raise RuntimeError(f"fused_beam_decode: no cluster of {heads} CTAs fits the card with the self caches "
                           f"{'on chip' if on_chip else 'in global memory'} (CUDA error {-n})")
    return n


def fused_beam_decode_kernel(params: dict, memory, memory_pad_mask, model_cfg: ModelConfig, dec_cfg: DecodeConfig,
                             return_scores: bool = False, *, on_chip: bool | None = None):
    """The kernel on CUDA tensors: one cluster of one CTA per head for each
    image, the self caches in shared memory or in a global scratch as
    ``geometry.k3_geometry`` says, or as ``on_chip`` says if given."""
    name = "fused_beam_decode"
    b, tm, d = memory.shape
    k, max_len = dec_cfg.beam_width, dec_cfg.max_len
    dec = pack_decode_params(params)["dec"]
    v = dec["tok_emb"].shape[0]
    if not should_use_megakernel(k, max_len, tm, v, mode="1"):
        raise ValueError(f"{name}: beam {k}, Tm {tm}, max_len {max_len}, vocab {v} outside the kernel's envelope "
                         f"({MIN_BEAM} <= beam <= {MAX_BEAM}, Tm <= {MAX_TM}, max_len <= {MAX_LEN}, "
                         f"vocab <= {MAX_VOCAB})")
    cdt = memory.dtype
    if not memory.is_cuda or cdt not in (torch.float32, torch.bfloat16):
        raise RuntimeError(f"{name}: memory must be a float32 or bfloat16 CUDA tensor, got {cdt} on "
                           f"{memory.device}")
    vw, itemsize = 16 // cdt.itemsize, cdt.itemsize
    f = model_cfg.dec_ffn_dim
    heads = model_cfg.num_heads
    if d % heads or (d // heads) % vw or f % heads or (f // heads) % vw or heads > MAX_CLUSTER:
        raise ValueError(f"{name}: D={d}, F={f}, heads={heads} (needs D/heads and F/heads multiples of {vw}, "
                         f"at most {MAX_CLUSTER} heads)")
    if dec["pos_emb"].shape[0] < max_len:
        raise ValueError(f"{name}: {dec['pos_emb'].shape[0]} positions, max_len {max_len}")
    n_layers = len(dec["layers_kernel"])
    vp = k3_vocab_cols(v, heads, vw)
    lib = build.load(build.library_name("decode_loop", cdt))
    lib.fused_beam_decode_max_layers.argtypes = []
    lib.fused_beam_decode_smem_bytes.argtypes = [ctypes.c_int] * 9
    max_layers = lib.fused_beam_decode_max_layers()
    if not 1 <= n_layers <= max_layers:
        raise ValueError(f"{name}: {n_layers} decoder layers, at most {max_layers}")
    ctas, fits, tc = k3_geometry(k, d, heads, f, max_len, v, n_layers, tm, itemsize)
    on_chip = fits if on_chip is None else on_chip
    smem = lib.fused_beam_decode_smem_bytes(k, d, heads, f, max_len, vp, n_layers, int(on_chip), tc)
    want = k3_smem_bytes(k, d, heads, f, max_len, vp, n_layers, on_chip, tc, itemsize)
    if smem != want:
        raise RuntimeError(f"{name}: the kernel needs {smem} bytes of shared memory, geometry.k3_smem_bytes "
                           f"counts {want}")
    if smem > SMEM_LIMIT:
        route = "on chip" if on_chip else "in global memory"
        raise ValueError(f"{name}: needs {smem} bytes of shared memory with the self caches {route}, "
                         f"more than {SMEM_LIMIT}")

    out_w = torch.zeros(d, vp, dtype=cdt, device=memory.device)
    out_w[:, :v] = dec["out"]["w"]
    out_b = torch.zeros(vp, dtype=torch.float32, device=memory.device)
    out_b[:v] = dec["out"]["b"]
    mem_valid_f = (~memory_pad_mask).to(torch.float32).contiguous()
    tokens = torch.empty(b, max_len + 2, dtype=torch.int32, device=memory.device)
    scores = torch.empty(b, k + 1, dtype=torch.float32, device=memory.device)
    # global route: each CTA's self-cache slice, (images, heads, layers, k|v, lanes, max_len, hd); every
    # slot is written by the kernel before it is read
    scratch = None if on_chip else torch.empty(b, ctas, n_layers, 2, k, max_len, d // heads, dtype=cdt,
                                               device=memory.device)
    # (operand, its dtype): the storage type, float32 or int32
    typed = [(dec["tok_emb"], cdt), (dec["pos_emb"], cdt), (out_w, cdt), (out_b, torch.float32),
             (mem_valid_f, torch.float32), (tokens, torch.int32), (scores, torch.float32), (scratch, cdt)]
    for lw, (mk, mv) in zip(dec["layers_kernel"], memory_kv(params, memory)):
        typed += [(lw[key], cdt if key in MATRIX_FIELDS else torch.float32) for key in WEIGHT_FIELDS]
        typed += [(mk, cdt), (mv, cdt)]
    for t, want in typed:
        if t is None:
            continue
        if t.device != memory.device or t.dtype != want:
            raise RuntimeError(f"{name}: an operand is {t.dtype} on {t.device}, not {want} on {memory.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: every operand must be contiguous and 16-byte aligned")
    tensors = [t for t, _ in typed]
    arr = (ctypes.c_void_p * len(tensors))(*[None if t is None else t.data_ptr() for t in tensors])
    fn = lib.fused_beam_decode_launch
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 16 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(memory.device).cuda_stream
    err = fn(ctypes.cast(arr, ctypes.c_void_p), b, k, n_layers, d, heads, f, tm, v, vp, max_len, dec_cfg.sos_idx,
             dec_cfg.eos_idx, dec_cfg.pad_idx, int(on_chip), tc, int(cdt == torch.bfloat16), stream)
    build.check(err, name)
    build.count_launch(stream, k3=1)
    if return_scores:
        return tokens.long(), scores
    return tokens.long()
