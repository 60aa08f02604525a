"""Bad fixture: a dead field, an unwired field, an undocumented field, and
a field only the JAX package reads."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    b_max: int = 16
    b_min: int = 1                 # read but never wired through the CLI
    scheduling_interval: int = 1   # dead: nothing reads it
    eps_m: float = 0.05            # wired + read but undocumented
    jax_only: int = 0              # documented, read only by src/repro
