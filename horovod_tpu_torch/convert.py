"""Carry transformer weights between the flax parameter tree of
``horovod_tpu.models.transformer.Transformer`` and the ``state_dict`` of
``horovod_tpu_torch.models.transformer.Transformer``.

The flax tree is plain nested dicts of numpy arrays (no flax import
here). Layouts:

* ``block_i/attn/{query,key,value}/kernel`` [d_model, H, D] ->
  ``blocks.i.attn.{query,key,value}.weight`` [H*D, d_model];
* ``block_i/attn/out/kernel`` [H, D, d_model] -> ``...attn.out.weight``
  [d_model, H*D];
* ``Dense_0``/``Dense_1``/``lm_head`` kernels [in, out] -> ``nn.Linear``
  weights [out, in];
* ``embed/embedding`` [vocab, d_model] -> ``embed.weight``;
* ``RMSNorm_0``/``RMSNorm_1`` of a block and the top-level ``RMSNorm_0``
  (the final norm) ``scale`` -> ``norm1``/``norm2``/``norm`` ``weight``.
"""

import numpy as np
import torch


def params_from_flax(params, cfg):
    """flax params (nested dict of arrays) -> torch ``state_dict`` (fp32)."""
    d = cfg.d_model

    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32))

    sd = {"embed.weight": t(params["embed"]["embedding"]),
          "norm.weight": t(params["RMSNorm_0"]["scale"]),
          "lm_head.weight": t(params["lm_head"]["kernel"]).T.contiguous()}
    for i in range(cfg.num_layers):
        blk, pre = params[f"block_{i}"], f"blocks.{i}."
        attn = blk["attn"]
        for name in ("query", "key", "value"):
            sd[pre + f"attn.{name}.weight"] = (
                t(attn[name]["kernel"]).reshape(d, d).T.contiguous())
        sd[pre + "attn.out.weight"] = (
            t(attn["out"]["kernel"]).reshape(d, d).T.contiguous())
        sd[pre + "norm1.weight"] = t(blk["RMSNorm_0"]["scale"])
        sd[pre + "norm2.weight"] = t(blk["RMSNorm_1"]["scale"])
        sd[pre + "mlp_in.weight"] = t(blk["Dense_0"]["kernel"]).T.contiguous()
        sd[pre + "mlp_out.weight"] = t(blk["Dense_1"]["kernel"]).T.contiguous()
    return sd


def flax_from_params(state_dict, cfg):
    """torch ``state_dict`` -> flax params (nested dict of numpy fp32)."""
    d, h = cfg.d_model, cfg.num_heads
    hd = d // h

    def n(key):
        return state_dict[key].detach().float().cpu().numpy()

    params = {"embed": {"embedding": n("embed.weight")},
              "RMSNorm_0": {"scale": n("norm.weight")},
              "lm_head": {"kernel": n("lm_head.weight").T.copy()}}
    for i in range(cfg.num_layers):
        pre = f"blocks.{i}."
        attn = {name: {"kernel": n(pre + f"attn.{name}.weight").T
                       .reshape(d, h, hd).copy()}
                for name in ("query", "key", "value")}
        attn["out"] = {"kernel": n(pre + "attn.out.weight").T
                       .reshape(h, hd, d).copy()}
        params[f"block_{i}"] = {
            "attn": attn,
            "RMSNorm_0": {"scale": n(pre + "norm1.weight")},
            "RMSNorm_1": {"scale": n(pre + "norm2.weight")},
            "Dense_0": {"kernel": n(pre + "mlp_in.weight").T.copy()},
            "Dense_1": {"kernel": n(pre + "mlp_out.weight").T.copy()},
        }
    return params
