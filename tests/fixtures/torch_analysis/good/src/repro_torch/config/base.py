"""Good fixture: every ServeConfig field is read, wired, documented."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    b_max: int = 16
