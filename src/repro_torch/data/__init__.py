from repro_torch.data.kg import (
    REDUCED_SCALE,
    TABLE4,
    KGStats,
    KnowledgeGraph,
    generate_synthetic_kg,
    load_dataset,
    split_kg,
)

__all__ = [
    "REDUCED_SCALE",
    "TABLE4",
    "KGStats",
    "KnowledgeGraph",
    "generate_synthetic_kg",
    "load_dataset",
    "split_kg",
]
