"""The reference's PyTorch checkpoints -> the JAX package's layout, in numpy.

Reads the reference's ``.pth``/``.pt`` state dicts (the se_vgg, vgg and
resnet module trees; raw state dicts and ``{'model_state_dict': ...}``
wrappers) and ``.safetensors`` files, and gives the parameter tree and the
BatchNorm statistics in the JAX package's layout as nested dicts of float32
numpy arrays, which ``from_jax.params_from_jax`` then takes.

Layout rules:
  * Conv2d OIHW -> HWIO
  * Linear / Conv1d(k=1) (out, in) -> (in, out)
  * MHA packed in_proj (3D, D) -> split q/k/v, each transposed
  * PatchEncoder Conv2d(512, D, k=(2,1)) -> (2*512, D) dense over the flattened
    (kh, c) axis
  * LSTM (4H, X) -> (X, 4H); torch gate order i,f,g,o is kept
  * BatchNorm weight/bias -> scale/bias params; running stats -> batch_stats

``detect_model_config`` reads the widths from the tensors: ``global_pos`` for
(max_global_len, emb_dim), ``dec.pos_emb`` for decode_max_len, the key names
for the backbone, the BiLSTM and the layer counts.

``.safetensors`` files are read here with numpy alone (an 8-byte
little-endian header length, a JSON header of dtype, shape and data offsets,
then the raw buffer); ``.pth``/``.pt`` through ``torch.load`` on the CPU, with
``weights_only=True``.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

from ..config import ModelConfig
from .from_jax import RESNET_STAGES, bf16_bits_to_f32

_SAFETENSORS_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16, "I64": np.int64, "I32": np.int32, "I16": np.int16,
    "I8": np.int8, "U64": np.uint64, "U32": np.uint32, "U16": np.uint16, "U8": np.uint8, "BOOL": np.bool_,
}


def load_safetensors(path: str | Path) -> dict[str, np.ndarray]:
    """A .safetensors file -> {name: array}; BF16 tensors are widened to
    float32 exactly, every other dtype kept."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n).decode("utf-8"))
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        dtype, shape = info["dtype"], tuple(info["shape"])
        raw = data[begin:end]
        if dtype == "BF16":
            arr = bf16_bits_to_f32(np.frombuffer(raw, "<u2"))
        elif dtype in _SAFETENSORS_DTYPES:
            arr = np.frombuffer(raw, np.dtype(_SAFETENSORS_DTYPES[dtype]).newbyteorder("<")).astype(
                _SAFETENSORS_DTYPES[dtype])
        else:
            raise ValueError(f"{path}: tensor {name!r} has dtype {dtype}, which this reader does not take")
        if arr.size != int(np.prod(shape)):
            raise ValueError(f"{path}: tensor {name!r} holds {arr.size} values for shape {shape}")
        out[name] = arr.reshape(shape)
    return out


def load_torch_checkpoint(path: str | Path) -> dict[str, np.ndarray]:
    """Load a .pth/.pt/.safetensors checkpoint into a flat {name: np.ndarray} dict."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"Model not found at {path}")
    if path.suffix == ".safetensors":
        return load_safetensors(path)
    import torch

    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state = ckpt.get("model_state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    out = {}
    for k, v in state.items():
        v = v.detach().cpu()
        out[k] = (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return out


def detect_model_config(state: dict[str, np.ndarray], vocab_size: int | None = None) -> ModelConfig:
    kw = {}
    if "global_pos" in state:
        kw["max_global_len"] = int(state["global_pos"].shape[0])
        kw["emb_dim"] = int(state["global_pos"].shape[1])
    if "dec.pos_emb" in state:
        kw["decode_max_len"] = int(state["dec.pos_emb"].shape[0])
    if "dec.tok_emb.weight" in state:
        kw["vocab_size"] = int(state["dec.tok_emb.weight"].shape[0])
    elif vocab_size is not None:
        kw["vocab_size"] = vocab_size
    kw["use_bilstm"] = any(k.startswith("context_bilstm.") for k in state)
    if any(k.startswith("cnn.layer1.") for k in state):
        kw["backbone"] = "resnet"
    elif any(k.startswith("cnn.se3.") for k in state):
        kw["backbone"] = "se_vgg"
    else:
        kw["backbone"] = "vgg"
    kw["enc_layers"] = 1 + max(
        (int(k.split(".")[2]) for k in state if k.startswith("enc.layers.")), default=1
    )
    kw["dec_layers"] = 1 + max(
        (int(k.split(".")[3]) for k in state if k.startswith("dec.decoder.layers.")), default=1
    )
    return dataclasses.replace(ModelConfig(), **kw)


def _f32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _linear(state, prefix) -> dict:
    return {"w": _f32(state[f"{prefix}.weight"]).T, "b": _f32(state[f"{prefix}.bias"])}


def _ln(state, prefix) -> dict:
    return {"scale": _f32(state[f"{prefix}.weight"]), "bias": _f32(state[f"{prefix}.bias"])}


def _conv(state, wkey, bkey=None) -> dict:
    p = {"w": _f32(state[wkey]).transpose(2, 3, 1, 0)}  # OIHW -> HWIO
    if bkey is not None and bkey in state:
        p["b"] = _f32(state[bkey])
    return p


def _bn(state, prefix) -> tuple[dict, dict]:
    return (
        {"scale": _f32(state[f"{prefix}.weight"]), "bias": _f32(state[f"{prefix}.bias"])},
        {"mean": _f32(state[f"{prefix}.running_mean"]), "var": _f32(state[f"{prefix}.running_var"])},
    )


def _se(state, prefix) -> dict:
    # SequenceSE.fc = Sequential(Conv1d, ReLU, Conv1d, Sigmoid) -> fc.0 / fc.2
    def c1d(i):
        w = _f32(state[f"{prefix}.fc.{i}.weight"])[:, :, 0].T  # (out,in,1) -> (in,out)
        return {"w": w, "b": _f32(state[f"{prefix}.fc.{i}.bias"])}

    return {"fc1": c1d(0), "fc2": c1d(2)}


def _mha(state, prefix) -> dict:
    w = _f32(state[f"{prefix}.in_proj_weight"])  # (3D, D)
    bias = _f32(state[f"{prefix}.in_proj_bias"])
    d = w.shape[1]
    qw, kw_, vw = w[:d], w[d : 2 * d], w[2 * d :]
    qb, kb, vb = bias[:d], bias[d : 2 * d], bias[2 * d :]
    return {
        "q": {"w": qw.T, "b": qb},
        "k": {"w": kw_.T, "b": kb},
        "v": {"w": vw.T, "b": vb},
        "o": _linear(state, f"{prefix}.out_proj"),
    }


def _enc_layer(state, prefix) -> dict:
    return {
        "self": _mha(state, f"{prefix}.self_attn"),
        "ln1": _ln(state, f"{prefix}.norm1"),
        "ln2": _ln(state, f"{prefix}.norm2"),
        "lin1": _linear(state, f"{prefix}.linear1"),
        "lin2": _linear(state, f"{prefix}.linear2"),
    }


def _dec_layer(state, prefix) -> dict:
    return {
        "self": _mha(state, f"{prefix}.self_attn"),
        "cross": _mha(state, f"{prefix}.multihead_attn"),
        "ln1": _ln(state, f"{prefix}.norm1"),
        "ln2": _ln(state, f"{prefix}.norm2"),
        "ln3": _ln(state, f"{prefix}.norm3"),
        "lin1": _linear(state, f"{prefix}.linear1"),
        "lin2": _linear(state, f"{prefix}.linear2"),
    }


def _lstm_dir(state, suffix="") -> dict:
    return {
        "w_ih": _f32(state[f"context_bilstm.weight_ih_l0{suffix}"]).T,
        "w_hh": _f32(state[f"context_bilstm.weight_hh_l0{suffix}"]).T,
        "b_ih": _f32(state[f"context_bilstm.bias_ih_l0{suffix}"]),
        "b_hh": _f32(state[f"context_bilstm.bias_hh_l0{suffix}"]),
    }


def _convert_se_vgg_backbone(state) -> tuple[dict, dict]:
    p, s = {}, {}
    for i in range(1, 7):
        p[f"conv{i}"] = _conv(state, f"cnn.conv{i}.0.weight", f"cnn.conv{i}.0.bias")
        p[f"bn_conv{i}"], s[f"bn_conv{i}"] = _bn(state, f"cnn.conv{i}.1")
    p["conv7"] = _conv(state, "cnn.conv7.weight", "cnn.conv7.bias")
    p["bn_conv7"], s["bn_conv7"] = _bn(state, "cnn.bn7")
    for name in ("se3", "se4", "se5"):
        p[name] = _se(state, f"cnn.{name}")
    return p, s


def _convert_vgg_backbone(state) -> tuple[dict, dict]:
    p, s = {}, {}
    for i in range(1, 7):
        p[f"conv{i}"] = _conv(state, f"cnn.conv{i}.0.weight", f"cnn.conv{i}.0.bias")
        p[f"bn_conv{i}"], s[f"bn_conv{i}"] = _bn(state, f"cnn.conv{i}.1")
    p["conv7"] = _conv(state, "cnn.conv7.weight", "cnn.conv7.bias")
    return p, s


def _convert_resnet_backbone(state) -> tuple[dict, dict]:
    p, s = {"stem_conv": _conv(state, "cnn.conv1.weight")}, {}
    p["stem_bn"], s["stem_bn"] = _bn(state, "cnn.bn1")
    for stage_i, (_, _, n_blocks) in enumerate(RESNET_STAGES):
        blocks_p, blocks_s = [], []
        for bidx in range(n_blocks):
            pre = f"cnn.layer{stage_i + 1}.{bidx}"
            bp = {
                "conv1": _conv(state, f"{pre}.conv1.weight"),
                "conv2": _conv(state, f"{pre}.conv2.weight"),
            }
            bs = {}
            bp["bn1"], bs["bn1"] = _bn(state, f"{pre}.bn1")
            bp["bn2"], bs["bn2"] = _bn(state, f"{pre}.bn2")
            if f"{pre}.shortcut.0.weight" in state:
                bp["short_conv"] = _conv(state, f"{pre}.shortcut.0.weight")
                bp["short_bn"], bs["short_bn"] = _bn(state, f"{pre}.shortcut.1")
            blocks_p.append(bp)
            blocks_s.append(bs)
        p[f"layer{stage_i + 1}"] = blocks_p
        s[f"layer{stage_i + 1}"] = blocks_s
    return p, s


_BACKBONE_CONVERTERS = {
    "se_vgg": _convert_se_vgg_backbone,
    "vgg": _convert_vgg_backbone,
    "resnet": _convert_resnet_backbone,
}


def convert_state_dict(state: dict[str, np.ndarray], cfg: ModelConfig | None = None):
    """Flat torch state dict -> (params, batch_stats, ModelConfig)."""
    cfg = cfg or detect_model_config(state)
    backbone_p, backbone_s = _BACKBONE_CONVERTERS[cfg.backbone](state)

    # PatchEncoder proj: (D, 512, 2, 1) -> (2*512, D) over the flattened (kh, c)
    # axis of the (B, 32, 2, C) -> (B, 32, 2C) reshape before the projection
    pw = _f32(state["patch.proj.weight"])[:, :, :, 0]  # (D, C, KH)
    pw = pw.transpose(2, 1, 0).reshape(-1, pw.shape[0])  # (KH*C, D)

    params = {
        "backbone": backbone_p,
        "patch": {
            "proj": {"w": pw, "b": _f32(state["patch.proj.bias"])},
            "pos_emb": _f32(state["patch.pos_emb"]),
        },
        "enc": [_enc_layer(state, f"enc.layers.{i}") for i in range(cfg.enc_layers)],
        "global_pos": _f32(state["global_pos"]),
        "dec": {
            "tok_emb": _f32(state["dec.tok_emb.weight"]),
            "pos_emb": _f32(state["dec.pos_emb"]),
            "layers": [_dec_layer(state, f"dec.decoder.layers.{i}") for i in range(cfg.dec_layers)],
            "out": _linear(state, "dec.out_proj"),
        },
    }
    if cfg.use_bilstm:
        params["bilstm"] = {"fw": _lstm_dir(state), "bw": _lstm_dir(state, "_reverse")}
    return params, backbone_s, cfg


def load_and_convert(path: str | Path, vocab_size: int | None = None):
    """-> (params, batch_stats, ModelConfig) of a .pth/.pt/.safetensors file."""
    state = load_torch_checkpoint(path)
    cfg = detect_model_config(state, vocab_size)
    return convert_state_dict(state, cfg)
