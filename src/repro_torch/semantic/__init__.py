"""Semantic augmentation (§4.4): the stub PTE, the sharded on-disk H_sem
store and its bounded device hot set."""
from repro_torch.semantic.pte import (PTEConfig, StubPTE,
                                      encode_normalized_batches,
                                      precompute_semantic_table)
from repro_torch.semantic.store import (SemanticCache, SemanticStore,
                                        SemanticStoreError,
                                        SemanticStoreWriter, SemStage,
                                        dequantize_int8,
                                        precompute_semantic_table_to_store,
                                        quantize_int8, training_budget_rows)

__all__ = [
    "PTEConfig",
    "StubPTE",
    "encode_normalized_batches",
    "precompute_semantic_table",
    "SemanticCache",
    "SemanticStore",
    "SemanticStoreError",
    "SemanticStoreWriter",
    "SemStage",
    "quantize_int8",
    "dequantize_int8",
    "precompute_semantic_table_to_store",
    "training_budget_rows",
]
