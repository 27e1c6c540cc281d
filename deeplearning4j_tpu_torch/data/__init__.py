"""Data containers and iterators (↔ deeplearning4j_tpu.data)."""
