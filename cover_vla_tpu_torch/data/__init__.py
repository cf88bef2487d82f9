from cover_vla_tpu_torch.data.stats import (
    DatasetStatistics, FieldStats, BRIDGE_STATS_PATH,
    normalize_bound, denormalize_bound,
    normalize_gaussian, denormalize_gaussian)
