"""Service limits the port's columnar path reads (config.go values, as
in the JAX package's config.py)."""

MAX_BATCH_SIZE = 1000  # gubernator.go:36

# Lane cap for ONE public columnar ingress request: a columnar client
# coalesces many callers' checks into one frame, so it carries more
# than the classic per-request cap.
INGRESS_COLUMNS_MAX_LANES = 16_384
