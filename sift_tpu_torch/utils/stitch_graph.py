"""STITCH-GRAPH file parser (the JAX package's ``utils/stitch_graph.py``).

The reference datasets carry per-scene match-graph files in a
``{key | value | comment}`` pipe format (e.g.
stitching/collection/Dataset/CAVE-01_atrium/CAVE-01_atrium-STITCH-GRAPH.txt):
center image index, center rotation angle (radians), image count, and an
adjacency list ``matching_graph_image_edges-<i> | j,k,...``.  The stitching
driver uses them to know which pairs to match and how to chain homographies
toward the center image.  Pure Python, a copy of the JAX package's.
"""

from __future__ import annotations

import dataclasses
import pathlib


@dataclasses.dataclass(frozen=True)
class StitchGraph:
    center_index: int
    center_rotation: float
    images_count: int
    edges: tuple[tuple[int, int], ...]  # undirected (i, j) with i < j

    def neighbors(self, i: int) -> list[int]:
        out = []
        for a, b in self.edges:
            if a == i:
                out.append(b)
            elif b == i:
                out.append(a)
        return sorted(out)

    def subset(self, available: int) -> "StitchGraph":
        """Restrict to the first ``available`` images (some dataset mounts
        ship fewer files than ``images_count`` declares); keeps edges among
        the available indices and re-centers if the center is missing."""
        edges = tuple(
            (a, b) for a, b in self.edges if a < available and b < available
        )
        center = self.center_index
        if center >= available:
            degree = [0] * available
            for a, b in edges:
                degree[a] += 1
                degree[b] += 1
            center = int(max(range(available), key=degree.__getitem__))
        return StitchGraph(center, self.center_rotation, available, edges)

    def bfs_parents(self) -> dict[int, int]:
        """Parent pointers toward the center image along graph edges."""
        from collections import deque

        parents: dict[int, int] = {self.center_index: self.center_index}
        q = deque([self.center_index])
        while q:
            u = q.popleft()
            for v in self.neighbors(u):
                if v not in parents:
                    parents[v] = u
                    q.append(v)
        return parents


def chain_graph(n: int) -> StitchGraph:
    """Consecutive images (i, i + 1), centered on the middle one: the graph
    of a scene directory without a STITCH-GRAPH file."""
    return StitchGraph(
        center_index=n // 2, center_rotation=0.0, images_count=n,
        edges=tuple((i, i + 1) for i in range(n - 1)),
    )


def parse_stitch_graph(path: str | pathlib.Path) -> StitchGraph:
    center = 0
    rotation = 0.0
    count = 0
    edges: list[tuple[int, int]] = []
    for line in pathlib.Path(path).read_text().splitlines():
        line = line.strip()
        if not (line.startswith("{") and line.endswith("}")):
            continue
        fields = [f.strip() for f in line[1:-1].split("|")]
        if len(fields) < 2:
            continue
        key, value = fields[0], fields[1]
        if key == "center_image_index":
            center = int(value)
        elif key == "center_image_rotation_angle":
            rotation = float(value)
        elif key == "images_count":
            count = int(value)
        elif key.startswith("matching_graph_image_edges-"):
            i = int(key.rsplit("-", 1)[1])
            for j in value.split(","):
                j = int(j)
                edges.append((min(i, j), max(i, j)))
    return StitchGraph(center, rotation, count, tuple(sorted(set(edges))))
