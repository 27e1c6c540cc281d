"""Neural-network library (↔ deeplearning4j_tpu.nn)."""
