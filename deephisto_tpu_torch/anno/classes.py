"""Annotation class registry: AnnoClass / AnnoDescription (copied from
``deephisto_tpu/anno/classes.py``).

Feature-parity port of the reference's class descriptors (reference
anno/utils.py:19-140) — same constructors, same alternate-label dictionary
behavior, same ``color_by_label`` surface.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable

from .palette import Palette


@dataclass
class AnnoClass:
    """One annotation class: id, label, optional alternates/description/color."""

    id: int
    label: str
    alternate_labels: tuple[str, ...] = ()
    description: str | None = None
    color: tuple[int, int, int] | None = None

    def __str__(self) -> str:
        label = self.label_full
        description = ", " + self.description if self.description else ""
        return f"AnnoClass [{self.id}, {label}, {self.color}{description}]"

    @property
    def label_full(self) -> str:
        if not self.alternate_labels:
            return self.label
        return self.label + " (" + ", ".join(self.alternate_labels) + ")"


class AnnoDescription:
    """The set of annotation classes, indexable by main or alternate label."""

    def __init__(self, anno_classes: Iterable[AnnoClass]) -> None:
        self.anno_classes = list(anno_classes)
        self.anno_classes_dict: dict[str, AnnoClass] = {}
        for c in self.anno_classes:
            self.anno_classes_dict[c.label] = c
            for alt in c.alternate_labels:
                self.anno_classes_dict[alt] = c

    @classmethod
    def with_known_colors(
        cls, labels_with_color: dict[str, tuple[int, int, int]]
    ) -> "AnnoDescription":
        return cls(
            AnnoClass(id=i, label=lbl, color=tuple(color))
            for i, (lbl, color) in enumerate(labels_with_color.items())
        )

    @classmethod
    def with_auto_colors(cls, labels: Iterable[str]) -> "AnnoDescription":
        labels = list(labels)
        palette = Palette(n_colors_max=len(labels), rng=42)
        return cls(
            AnnoClass(id=i, label=lbl, color=palette.colors[i])
            for i, lbl in enumerate(labels)
        )

    @classmethod
    def auto_from_files(cls, path: list[Path] | Path) -> "AnnoDescription":
        """Scan one annotation JSON file or a folder of them for class labels
        (reference anno/utils.py:98-129)."""
        path = Path(path)
        if path.is_dir():
            anno_files = sorted(f for f in path.iterdir() if f.suffix == ".json")
        elif path.is_file() and path.suffix == ".json":
            anno_files = [path]
        else:
            anno_files = []
        if not anno_files:
            raise RuntimeError("No annotation files found")
        labels: set[str] = set()
        for f in anno_files:
            for anno in json.loads(f.read_text()):
                if isinstance(anno, dict):
                    labels.add(anno["class"])
        return cls.with_auto_colors(sorted(labels))

    def color_by_label(self, label: str) -> tuple[int, int, int]:
        return self.anno_classes_dict[label].color

    def __len__(self) -> int:
        return len(self.anno_classes)
