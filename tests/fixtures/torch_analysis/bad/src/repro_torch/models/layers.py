"""Bad fixture: syncs inside a model function, which runs in a captured
step."""
import torch


def attention(q, mask):
    n = mask.sum().tolist()                        # host-sync: line 7
    idx = torch.nonzero(mask)                      # host-sync: line 8
    return q[:n], idx
