"""Checkpoint interchange (↔ deeplearning4j_tpu.serde)."""
