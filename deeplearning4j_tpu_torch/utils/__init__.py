"""Utilities (↔ deeplearning4j_tpu.utils)."""
