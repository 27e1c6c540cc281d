"""Training (↔ deeplearning4j_tpu.train). Only updater configs so far."""
