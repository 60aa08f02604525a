"""Bad fixture: a kernel wrapper that waits for its launch."""
import torch


def launch(x):
    torch.cuda.synchronize()                       # host-sync: line 6
    return x
