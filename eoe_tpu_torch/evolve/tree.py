"""Genealogical tree of the evolutionary OE search: the port of
eoe_tpu/evolve/tree.py, pure Python (no torch).

Nodes carry a UUID, parent and child edges and an ``Individual`` (values,
image file, fitness); ``Tree`` has BFS/DFS traversal, ``get`` by values,
de-duplicated ``topk`` best/worst queries, and JSON (de)serialisation in
the JAX package's schema, so either package reads the other's
``evolution.json``. ``render`` (the genealogy) and ``overview_figure`` (the
best/worst samples) draw with matplotlib where it imports and return None
where it does not.
"""

import json
import os.path as pt
import uuid as uuid_mod
from typing import List, Optional, Sequence


class Individual:
    def __init__(self, values: Sequence[int], file: Optional[str] = None,
                 fitness: Optional[float] = None):
        self.values = list(values)
        self.file = file
        self.fitness = fitness

    def to_json(self):
        return {"values": self.values, "file": self.file, "fitness": self.fitness}

    @staticmethod
    def from_json(d):
        return Individual(d["values"], d.get("file"), d.get("fitness"))

    def __repr__(self):
        return f"Individual({self.values}, fitness={self.fitness})"


class EvolNode:
    def __init__(self, content: Individual, uuid: Optional[str] = None):
        self.content = content
        self.uuid = uuid or str(uuid_mod.uuid4())
        self.children: List["EvolNode"] = []
        self.parents: List["EvolNode"] = []

    def add_children(self, *nodes: "EvolNode"):
        for n in nodes:
            if n not in self.children:
                self.children.append(n)
            if self not in n.parents:
                n.parents.append(self)


class Tree:
    """Root is a virtual node; generation-0 individuals are its children."""

    def __init__(self, *nodes: EvolNode):
        self.root = EvolNode(Individual([]), uuid="root")
        self.root.add_children(*nodes)

    def bfs(self) -> List[EvolNode]:
        seen, order, queue = {id(self.root)}, [self.root], [self.root]
        while queue:
            node = queue.pop(0)
            for c in node.children:
                if id(c) not in seen:
                    seen.add(id(c))
                    order.append(c)
                    queue.append(c)
        return order

    def dfs(self) -> List[EvolNode]:
        seen, order, stack = set(), [], [self.root]
        while stack:
            node = stack.pop()
            if id(node) in seen:
                continue
            seen.add(id(node))
            order.append(node)
            stack.extend(reversed(node.children))
        return order

    def get(self, individual) -> Optional[EvolNode]:
        """The LATEST node whose values match the individual's."""
        values = list(individual)
        match = None
        for n in self.bfs()[1:]:
            if n.content.values == values:
                match = n
        return match

    # -------------------------------------------------------------- queries

    def topk(self, k: int = 16, best: bool = True) -> List[EvolNode]:
        """De-duplicated (by values) best/worst evaluated nodes."""
        nodes = [n for n in self.bfs()[1:] if n.content.fitness is not None]
        seen, unique = set(), []
        for n in sorted(nodes, key=lambda n: n.content.fitness, reverse=best):
            key = tuple(n.content.values)
            if key not in seen:
                seen.add(key)
                unique.append(n)
        return unique[:k]

    # -------------------------------------------------------------- io

    def save(self, path: str):
        if not path.endswith(".json"):
            path = path + ".json"
        nodes = self.bfs()
        payload = {
            "nodes": [{"uuid": n.uuid, **n.content.to_json()} for n in nodes],
            "edges": [[p.uuid, c.uuid] for p in nodes for c in p.children],
        }
        with open(path, "w") as f:
            json.dump(payload, f)

    def load(self, path: str) -> "Tree":
        with open(path) as f:
            payload = json.load(f)
        by_uuid = {}
        for nd in payload["nodes"]:
            node = EvolNode(Individual.from_json(nd), uuid=nd["uuid"])
            by_uuid[node.uuid] = node
        for p, c in payload["edges"]:
            by_uuid[p].add_children(by_uuid[c])
        self.root = by_uuid.get("root") or next(iter(by_uuid.values()))
        return self

    # -------------------------------------------------------------- figures

    def render(self, path: str, oeds=None, max_nodes: int = 400):
        """Render the genealogy as a layered graph: nodes placed by BFS depth,
        colored by fitness, parent->child edges; optional thumbnail images
        when ``oeds`` is given and the tree is small."""
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            from matplotlib import cm
        except Exception:
            return None
        # BFS depth per node
        depth = {id(self.root): -1}
        order = []
        queue = [self.root]
        while queue and len(order) < max_nodes:
            node = queue.pop(0)
            for c in node.children:
                if id(c) not in depth:
                    depth[id(c)] = depth[id(node)] + 1
                    order.append(c)
                    queue.append(c)
        by_depth = {}
        pos = {}
        for n in order:
            d = depth[id(n)]
            by_depth.setdefault(d, []).append(n)
        for d, nodes in by_depth.items():
            for i, n in enumerate(nodes):
                pos[id(n)] = (i - len(nodes) / 2, -d)
        fits = [n.content.fitness for n in order if n.content.fitness is not None]
        lo, hi = (min(fits), max(fits)) if fits else (0.0, 1.0)
        fig, ax = plt.subplots(figsize=(max(6, len(by_depth.get(0, [])) * 0.5),
                                        max(4, len(by_depth) * 0.8)))
        for n in order:
            x, y = pos[id(n)]
            for c in n.children:
                if id(c) in pos:
                    cx, cy = pos[id(c)]
                    ax.plot([x, cx], [y, cy], "-", color="0.8", lw=0.5, zorder=1)
        for n in order:
            x, y = pos[id(n)]
            f = n.content.fitness
            color = cm.viridis((f - lo) / max(hi - lo, 1e-9)) if f is not None else "0.6"
            ax.scatter([x], [y], s=40, color=color, zorder=2)
            if f is not None and len(order) <= 80:
                ax.annotate(f"{f * 100:.1f}", (x, y), fontsize=5,
                            xytext=(0, 5), textcoords="offset points", ha="center")
        ax.set_axis_off()
        ax.set_title("OE evolution genealogy (color = fitness)")
        fig.savefig(path, bbox_inches="tight", dpi=150)
        plt.close(fig)
        return path

    def imsave_collection_best(self, logger, msms=(), oeds=None, k: int = 16):
        """Final best/worst overview figures in the run directory. ``oeds``
        enables rendering from raw data; otherwise skipped silently (the
        per-individual PNGs already exist)."""
        if oeds is None:
            return
        for best in (True, False):
            name = "best" if best else "worst"
            self.overview_figure(oeds, pt.join(logger.dir, f"overview_{name}.png"),
                                 k=k, best=best)

    def overview_figure(self, oeds, path: str, k: int = 16, best: bool = True):
        """Grid of the k best/worst OE samples with fitness captions."""
        import numpy as np
        nodes = self.topk(k, best)
        if not nodes:
            return None
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:
            return None
        fig, axes = plt.subplots(1, len(nodes), figsize=(2 * len(nodes), 2.6), squeeze=False)
        for ax, n in zip(axes[0], nodes):
            imgs = oeds.gather(np.asarray(n.content.values) % len(oeds))
            ax.imshow(imgs[0] if imgs.shape[-1] == 3 else imgs[0][..., 0], cmap="gray")
            ax.set_title(f"{n.content.fitness * 100:05.2f}%", fontsize=8)
            ax.axis("off")
        fig.suptitle(("best" if best else "worst") + " OE samples")
        fig.savefig(path, bbox_inches="tight")
        plt.close(fig)
        return path
