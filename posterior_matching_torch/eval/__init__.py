"""Eval metrics: PRD and the embedder it reads (counterpart of
``posterior_matching_tpu/eval``; the clustering-accuracy callback comes
with VaDE, ``ROADMAP.md`` A10)."""
from posterior_matching_torch.eval.embeddings import (
    embedder_provenance,
    get_inception_embeddings,
)
from posterior_matching_torch.eval.prd import (
    compute_prd,
    compute_prd_from_embedding,
    prd_to_max_f_beta_pair,
)

__all__ = [
    "compute_prd",
    "compute_prd_from_embedding",
    "embedder_provenance",
    "get_inception_embeddings",
    "prd_to_max_f_beta_pair",
]
