"""Formats, metrics and the plain torch SpMV/SpMM tiers."""
