"""Device side of Stage B: the kernels' wrappers and their plain versions."""
import numpy as np
import torch


def upload(tree, device):
    """A tree (dicts, lists, tuples, None) of NumPy arrays -> the same tree
    of tensors on device."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: upload(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(upload(v, device) for v in tree)
    return torch.from_numpy(np.ascontiguousarray(tree)).to(device)
