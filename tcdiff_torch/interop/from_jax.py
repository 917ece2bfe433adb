"""Load flax param trees (the DanceDecoder's, the DBN's) into the port.

`params_to_state_dict` maps the flax tree (numpy leaves, or anything
`np.asarray` takes) onto the reference state-dict layout the port's modules
are named after: Dense kernels (in, out) become Linear weights (out, in),
the cond encoder's separate q/k/v projections are concatenated into
`in_proj_weight`/`in_proj_bias`, and the deterministic rotary `freqs`
buffers are added. The map is linear, so it also carries trees of the same
structure that are not weights (gradients, optimizer moments) to the
parameter names, which is how the tests compare them.

`traj_params_to_state_dict` maps the flax TrajDecoder tree onto the
reference's DBN state-dict names (the inverse of the JAX package's
`traj_decoder_params_from_torch`), and `load_reference_traj` loads a
reference-layout `{'net': state_dict}` checkpoint.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from tcdiff_torch.models.dance_decoder import DanceDecoder
from tcdiff_torch.trajdecoder.model import TrajDecoder
from tcdiff_torch.models.rotary import inv_freq_buffer


def _w(kernel) -> np.ndarray:
    """flax kernel (in, out) -> torch Linear weight (out, in)."""
    return np.ascontiguousarray(np.asarray(kernel).T)


def _dense(sd: Dict, prefix: str, p: Mapping) -> None:
    sd[prefix + ".weight"] = _w(p["kernel"])
    if "bias" in p:
        sd[prefix + ".bias"] = np.asarray(p["bias"])


def _ln(sd: Dict, prefix: str, p: Mapping) -> None:
    sd[prefix + ".weight"] = np.asarray(p["scale"])
    sd[prefix + ".bias"] = np.asarray(p["bias"])


def _mha(sd: Dict, prefix: str, p: Mapping) -> None:
    qkv = ("q_proj", "k_proj", "v_proj")
    sd[prefix + ".in_proj_weight"] = np.concatenate([_w(p[n]["kernel"]) for n in qkv])
    sd[prefix + ".in_proj_bias"] = np.concatenate([np.asarray(p[n]["bias"]) for n in qkv])
    _dense(sd, prefix + ".out_proj", p["out_proj"])


def _sbi(sd: Dict, prefix: str, p: Mapping) -> None:
    for name in ("w_qs", "w_ks", "w_vs", "fc"):
        _dense(sd, f"{prefix}.{name}", p[name])
    _ln(sd, prefix + ".layer_norm", p["layer_norm"])


def params_to_state_dict(params: Mapping, num_layers: int, latent_dim: int) -> Dict[str, np.ndarray]:
    """flax DanceDecoder tree -> reference-format state dict (numpy)."""
    freqs = inv_freq_buffer(latent_dim)
    sd: Dict = {"rotary.freqs": freqs}
    _dense(sd, "input_projection", params["input_projection"])
    _dense(sd, "final_layer", params["final_layer"])
    _dense(sd, "traj_embedding.0", params["traj_embedding_0"])
    _dense(sd, "traj_embedding.2", params["traj_embedding_1"])
    for i in range(3):
        _dense(sd, f"relative_projection_layer.{2 * i}", params[f"relative_projection_{i}"])
    _dense(sd, "cond_projection.0", params["cond_projection_0"])
    _dense(sd, "cond_projection.2", params["cond_projection_1"])
    _ln(sd, "non_attn_cond_projection.0", params["non_attn_norm"])
    _dense(sd, "non_attn_cond_projection.1", params["non_attn_dense0"])
    _dense(sd, "non_attn_cond_projection.3", params["non_attn_dense1"])
    _dense(sd, "time_mlp.1", params["time_mlp"])
    _dense(sd, "to_time_cond.0", params["to_time_cond"])
    _dense(sd, "to_time_tokens.0", params["to_time_tokens"])
    _ln(sd, "norm_cond", params["norm_cond"])
    sd["null_cond_embed"] = np.asarray(params["null_cond_embed"])
    sd["null_cond_hidden"] = np.asarray(params["null_cond_hidden"])
    sd["embeddings_table.weight"] = np.asarray(params["embeddings_table"])
    for i in range(2):
        enc, pre = params[f"cond_encoder_{i}"], f"cond_encoder.{i}"
        sd[pre + ".rotary.freqs"] = freqs
        _mha(sd, pre + ".self_attn", enc["self_attn"])
        for name in ("linear1", "linear2"):
            _dense(sd, f"{pre}.{name}", enc[name])
        for name in ("norm1", "norm2"):
            _ln(sd, f"{pre}.{name}", enc[name])
    for i in range(num_layers):
        dec, pre = params[f"decoder_{i}"], f"seqTransDecoder.stack.{i}"
        sd[pre + ".rotary.freqs"] = freqs
        _sbi(sd, pre + ".self_attn", dec["self_attn"])
        _sbi(sd, pre + ".multihead_attn", dec["multihead_attn"])
        for name in ("linear1", "linear2", "linear3"):
            _dense(sd, f"{pre}.{name}", dec[name])
        for name in ("norm1", "norm2", "norm3", "norm4"):
            _ln(sd, f"{pre}.{name}", dec[name])
        for j in (1, 2, 3):
            _dense(sd, f"{pre}.film{j}.block.1", dec[f"film{j}"]["block"])
        for j in range(3):
            cs, cpre = dec[f"traj_mod{j}"], f"{pre}.traj_Modulation.{j}"
            for name in ("layer", "hyper_bias", "hyper_gate"):
                _dense(sd, f"{cpre}._{name}", cs[name])
    return sd


def _load_strict(model: torch.nn.Module, sd: Mapping) -> None:
    model.load_state_dict({k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}, strict=True)


def load_jax_params(model: DanceDecoder, params: Mapping) -> DanceDecoder:
    """Copy a flax param tree into `model` (strict: every key must match)."""
    _load_strict(model, params_to_state_dict(params, model.cfg.num_layers, model.cfg.latent_dim))
    return model


def traj_params_to_state_dict(params: Mapping, trans_layer: int = 6) -> Dict[str, np.ndarray]:
    """flax TrajDecoder tree -> the reference's DBN state dict (numpy)."""
    sd: Dict = {f"lstm.{k}": np.asarray(v) for k, v in params["lstm"].items()}
    for i in range(3):
        _dense(sd, f"music_projection.{2 * i}", params[f"music_projection_{i}"])
    _dense(sd, "trans_extractor.cond_emb", params["cond_emb"])
    _dense(sd, "trans_extractor.traj_emb", {"kernel": params["traj_emb_kernel"], "bias": params["traj_emb_bias"]})
    for i in range(4):
        _dense(sd, f"Decoder.{2 * i}", params[f"decoder_{i}"])
    for i in range(trans_layer):
        blk, pre = params[f"block_{i}"], f"trans_extractor.blocks.{i}"
        _ln(sd, pre + ".ln1", blk["ln1"])
        _ln(sd, pre + ".ln2", blk["ln2"])
        for name in ("query", "key", "value", "proj"):
            _dense(sd, f"{pre}.attn.{name}", blk[name])
        _dense(sd, pre + ".mlp.0", blk["mlp0"])
        _dense(sd, pre + ".mlp.2", blk["mlp2"])
    return sd


def load_jax_traj_params(model: TrajDecoder, params: Mapping) -> TrajDecoder:
    """Copy a flax TrajDecoder param tree into `model` (strict: every key
    must match)."""
    _load_strict(model, traj_params_to_state_dict(params, model.cfg.trans_layer))
    return model


def load_reference_traj(model: TrajDecoder, path: str) -> TrajDecoder:
    """Load a reference-layout DBN checkpoint, `{'net': state_dict}`
    (`TrajDecoder/train_traj.py:281-282`; the `.pt` branch of the JAX
    package's `TCDiff._load_traj_params`). Every parameter of `model` must
    be in it; what the network does not hold as a parameter (a buffer of
    the reference's, such as its unused attention mask) is skipped, as the
    JAX package's converter skips it."""
    sd = torch.load(path, map_location="cpu", weights_only=False)["net"]
    names = set(model.state_dict())
    _load_strict(model, {k: v.detach().cpu().numpy() for k, v in sd.items() if k in names})
    return model
