"""Op namespaces (↔ deeplearning4j_tpu.ops)."""
