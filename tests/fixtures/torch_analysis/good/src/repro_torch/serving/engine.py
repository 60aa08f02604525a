"""Good fixture: a miniature port engine with no lint violation but its
one allowlisted fence."""


class Engine:
    def __init__(self, blocks):
        self.blocks = blocks
        self.finished = 0

    def _retire_step(self, rec):
        # the lone sync point; absorbed by the fixture allowlist
        rec.event.synchronize()
        return rec.host

    def free(self, rid):
        # mutation through the manager API, not its internals
        self.blocks.free(rid)
        n = len(self.blocks.tables)  # reads are fine
        return n

    def summary(self):
        return {
            "finished": self.finished,
        }
