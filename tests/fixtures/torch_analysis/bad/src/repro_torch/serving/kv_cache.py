"""Bad fixture allocator (the violations live in engine.py)."""


class BlockManager:
    def __init__(self):
        self.tables = {}
        self.ref = {}
        self._free = []
