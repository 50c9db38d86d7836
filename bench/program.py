"""The program under test, as the harness drives it: repro_torch's
MemoryStore (create, calibrate, write) and RetrievalEngine.search, with
the configuration's search settings. Nothing else of the program is read
but the spans, ranges and kernel names its calls leave in a trace."""

from __future__ import annotations


class Port:
    def __init__(self, config: dict, device):
        from repro_torch.core.avss import SearchConfig
        from repro_torch.core.mcam import MCAMConfig
        from repro_torch.core.memory import MemoryConfig
        from repro_torch.engine import (MemoryStore, RetrievalEngine,
                                        SearchRequest)
        search = SearchConfig(encoding=config["encoding"], cl=config["cl"],
                              mode=config["mode"],
                              mcam=MCAMConfig(**config["mcam"]),
                              noisy=config["noisy"])
        self.cfg = MemoryConfig(capacity=config["capacity"],
                                dim=config["dim"], search=search,
                                clip_std=config["clip_std"])
        self.engine = RetrievalEngine(search)
        self.device = device
        self._store, self._request = MemoryStore, SearchRequest

    def create(self):
        return self._store.create(self.cfg, self.device)

    def request(self, mode: str, k: int):
        return self._request(mode=mode, k=max(k, 1))

    def search(self, store, queries, request):
        return self.engine.search(store, queries, request)
