"""Device discovery (↔ deeplearning4j_tpu.runtime)."""
