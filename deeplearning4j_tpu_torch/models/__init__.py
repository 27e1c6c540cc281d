"""Model families (↔ deeplearning4j_tpu.models)."""
