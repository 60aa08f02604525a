"""Bad fixture: one host-sync per torch sync call, allocator and
counter-parity violations, at known lines."""
import numpy as np
import torch


class Engine:
    def __init__(self, blocks):
        self.blocks = blocks
        self.finished = 0
        self.preemptions = 0

    def step(self, x, ev, stream):
        a = x.item()                               # host-sync: line 14
        b = x.tolist()                             # host-sync: line 15
        c = x.cpu()                                # host-sync: line 16
        d = c.numpy()                              # host-sync: line 17
        e = x.to("cpu")                            # host-sync: line 18
        f = x.to(torch.device("cpu"))              # host-sync: line 19
        g = x.to(device="cpu", dtype=torch.half)   # host-sync: line 20
        torch.cuda.synchronize()                   # host-sync: line 21
        ev.synchronize()                           # host-sync: line 22
        stream.synchronize()                       # host-sync: line 23
        h = torch.nonzero(x)                       # host-sync: line 24
        i = x.nonzero()                            # host-sync: line 25
        j = np.asarray(x)                          # host-sync: line 26
        k = np.array(x)                            # host-sync: line 27
        return a, b, c, d, e, f, g, h, i, j, k

    def clean(self, x, host):
        # none of these waits for the device
        y = x.to(torch.float32).to("cuda", non_blocking=True)
        host.copy_(y, non_blocking=True)
        return y, np.array([1, 2, 3]), {"a": 1}.items()

    def evict(self, rid, b):
        self.blocks.ref[b] -= 1                    # allocator: line 37
        self.blocks.tables[rid].append(b)          # allocator: line 38
        del self.blocks.tables[rid]                # allocator: line 39

    def summary(self):
        return {
            "finished": self.finished,
            "preemptions": self.preemptions,       # counter-parity: line 44
        }
