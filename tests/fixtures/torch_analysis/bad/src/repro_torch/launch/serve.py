"""Bad fixture CLI: wires b_max and eps_m only."""
from repro_torch.config.base import ServeConfig


def main(args):
    serve = ServeConfig(b_max=args.b_max, eps_m=args.eps_m)
    return serve.b_max + serve.b_min + serve.eps_m
