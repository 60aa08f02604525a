"""Bad fixture: SimResult carries a sim-only scalar the engine lacks."""
import dataclasses
from typing import List


@dataclasses.dataclass
class SimResult:
    finished: int = 0
    oom_events: int = 0                            # counter-parity: line 9
    batch_trace: List[int] = dataclasses.field(default_factory=list)

    @property
    def throughput(self) -> float:                 # counter-parity: line 13
        return float(self.finished)
