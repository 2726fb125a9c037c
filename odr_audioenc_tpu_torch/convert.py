"""Carry state and tables between the JAX package and the port.

The encoder has no learned weights: its "parameters" are the psy-1 tables
and its carried state, the polyphase history `hist` [S, 2, 480].  Both cross
as numpy, so a stream encoded by the JAX encoder can continue in the port
(and back) and its bitstream stays exactly the same.
"""
import numpy as np
import torch


def state_from_numpy(state_np, device):
    """JAX `init_state`/`take_state` rows (as numpy) -> the port's state."""
    return {"hist": torch.as_tensor(np.array(state_np["hist"]), device=device)}


def state_to_numpy(state):
    """The port's state -> numpy rows the JAX encoder's `put_state` takes."""
    return {"hist": state["hist"].detach().cpu().numpy()}


def tables_from_numpy(tabs, device, dtype=torch.float64):
    """psy-1 tables (make_psy1_tables / make_fast_tables output, numpy) ->
    tensors on `device`: floats in `dtype`, integers as int64.  The static
    minimum_mask structure becomes (mask, tail, j index, has_match, ss); the
    fused tonal+noise kernel's geometry (`static_noise_uniform`) is dropped,
    since that kernel is not ported."""
    def tensor(v):
        v = np.asarray(v)
        if v.dtype == bool:
            return torch.as_tensor(v, device=device)
        if np.issubdtype(v.dtype, np.integer):
            return torch.as_tensor(v.astype(np.int64), device=device)
        return torch.as_tensor(v, device=device).to(dtype)

    out = {}
    for k, v in tabs.items():
        if k == "static_noise_uniform" or v is None:
            continue
        if k == "static_mm":
            mask, tail, j_onehot, has_match, ss = v
            out[k] = (tensor(mask), tensor(tail),
                      tensor(np.asarray(j_onehot).argmax(axis=0)), tensor(has_match),
                      int(ss))
        else:
            out[k] = tensor(v)
    return out


def to_numpy(out):
    """Step outputs (dict of tensors) -> numpy, as the host packer takes."""
    return {k: v.detach().cpu().numpy() for k, v in out.items()}
