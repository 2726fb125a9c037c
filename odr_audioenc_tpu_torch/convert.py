"""Carry state and tables between the JAX package and the port.

The encoder has no learned weights: its "parameters" are the psy tables and
its carried state, the polyphase history `hist` [S, 2, 480] and, for psy
models 2 and 4, the `psy2` leaves (`savebuf` [2S, 1056] and `r_m1`, `r_m2`,
`p_m1`, `p_m2` [2S, 513], channel-major as the JAX `take_state` lays them
out).  Both cross as numpy, so a stream encoded by the JAX encoder can
continue in the port (and back) and its bitstream stays exactly the same.
"""
import numpy as np
import torch


def state_from_numpy(state_np, device):
    """JAX `init_state`/`take_state` rows (as numpy) -> the port's state."""
    def tensor(v):
        return torch.as_tensor(np.array(v), device=device)
    out = {"hist": tensor(state_np["hist"])}
    if "psy2" in state_np:
        out["psy2"] = {k: tensor(v) for k, v in state_np["psy2"].items()}
    return out


def state_to_numpy(state):
    """The port's state -> numpy rows the JAX encoder's `put_state` takes."""
    out = {"hist": state["hist"].detach().cpu().numpy()}
    if "psy2" in state:
        out["psy2"] = {k: v.detach().cpu().numpy() for k, v in state["psy2"].items()}
    return out


def tables_from_numpy(tabs, device, dtype=torch.float64):
    """psy tables (numpy: make_psy1_tables / make_fast_tables,
    make_psy2/3/4_tables, psy-0 ath_min) -> tensors on `device`: floats in
    `dtype`, integers as int64, Python ints as they are.  The static
    minimum_mask structure becomes (mask, tail, j index, has_match, ss); the
    fused tonal+noise kernel's uniform geometry `static_noise_uniform`
    becomes (bmt [512, 32], base [32], span [32])."""
    def tensor(v):
        v = np.asarray(v)
        if v.dtype == bool:
            return torch.as_tensor(v, device=device)
        if np.issubdtype(v.dtype, np.integer):
            return torch.as_tensor(v.astype(np.int64), device=device)
        return torch.as_tensor(v, device=device).to(dtype)

    out = {}
    for k, v in tabs.items():
        if v is None:
            continue
        if isinstance(v, int):
            out[k] = v
        elif k == "static_mm":
            mask, tail, j_onehot, has_match, ss = v
            out[k] = (tensor(mask), tensor(tail),
                      tensor(np.asarray(j_onehot).argmax(axis=0)), tensor(has_match),
                      int(ss))
        elif k == "static_noise_uniform":
            out[k] = tuple(tensor(x) for x in v)
        else:
            out[k] = tensor(v)
    return out


def to_numpy(out):
    """Step outputs (dict of tensors) -> numpy, as the host packer takes."""
    return {k: v.detach().cpu().numpy() for k, v in out.items()}
