"""Columnar tables, micro-partitions and synthetic data generation."""
