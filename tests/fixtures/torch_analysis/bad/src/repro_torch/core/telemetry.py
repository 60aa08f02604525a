"""Bad fixture: core/ runs on host values only, outside host-sync's
scope: nothing here is flagged."""


def mean(x):
    return x.item()
