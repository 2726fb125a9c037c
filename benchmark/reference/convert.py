"""Tables and step outputs between numpy and torch."""
import numpy as np
import torch


def tables_from_numpy(tabs, device, dtype=torch.float64):
    """psy-1 tables (numpy, make_psy1_tables) -> tensors on `device`: floats
    in `dtype`, integers as int64."""
    def tensor(v):
        v = np.asarray(v)
        if np.issubdtype(v.dtype, np.integer):
            return torch.as_tensor(v.astype(np.int64), device=device)
        return torch.as_tensor(v, device=device).to(dtype)

    return {k: tensor(v) for k, v in tabs.items()}


def to_numpy(out):
    """Step outputs (dict of tensors, or already numpy) -> numpy, as the
    host packer takes."""
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in out.items()}
