"""Expert bucketing and batch sizing."""

from gpsat_tpu_torch.parallel.scheduler import (  # noqa: F401
    auto_batch_size, bucket_level, make_buckets)
