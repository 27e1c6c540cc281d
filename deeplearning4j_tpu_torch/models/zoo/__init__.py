"""Model zoo (↔ deeplearning4j_tpu.models.zoo)."""
