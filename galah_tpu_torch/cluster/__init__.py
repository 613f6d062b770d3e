"""Clustering: pair cache, precluster partition, greedy engine."""
