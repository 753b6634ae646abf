from repro_torch.data.kg import (
    REDUCED_SCALE,
    TABLE4,
    KGSnapshot,
    KGStats,
    KnowledgeGraph,
    SnapshotUnavailable,
    generate_synthetic_kg,
    load_dataset,
    split_kg,
)
from repro_torch.data.pipeline import batch_entity_ids

__all__ = [
    "REDUCED_SCALE",
    "TABLE4",
    "batch_entity_ids",
    "KGSnapshot",
    "KGStats",
    "KnowledgeGraph",
    "SnapshotUnavailable",
    "generate_synthetic_kg",
    "load_dataset",
    "split_kg",
]
