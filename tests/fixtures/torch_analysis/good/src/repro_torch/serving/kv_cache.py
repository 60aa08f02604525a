"""Good fixture: the allocator owns and mutates its own state."""


class BlockManager:
    def __init__(self):
        self.tables = {}
        self.ref = {}
        self._free = []

    def free(self, rid):
        for b in self.tables.pop(rid, []):
            self.ref[b] -= 1
            if self.ref[b] == 0:
                self._free.append(b)
