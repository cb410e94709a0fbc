"""Hippo core: bitmaps, histogram, predicates, grouping, index, partition."""
