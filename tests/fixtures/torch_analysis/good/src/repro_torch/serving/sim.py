"""Good fixture: SimResult mirrors Engine.summary() exactly."""
import dataclasses
from typing import List


@dataclasses.dataclass
class SimResult:
    finished: int = 0
    batch_trace: List[int] = dataclasses.field(default_factory=list)
