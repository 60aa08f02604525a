"""Good fixture: the CLI wires every ServeConfig field."""
from repro_torch.config.base import ServeConfig


def main(args):
    serve = ServeConfig(b_max=args.b_max)
    return serve.b_max
