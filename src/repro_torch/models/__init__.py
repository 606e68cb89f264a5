"""Language models: the dense transformer family, its attention, FFNs
(dense SwiGLU / GELU and the block-sparse FFN on the BCSR kernel) and
shared helpers."""
