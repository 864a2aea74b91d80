from .mesh import (DataParallel, replicate, replicate_pool, select_devices,
                   shard_device_batch, shard_imag_state)
from .multihost import (global_batch_from_local, global_replicated_from_full,
                        initialize as initialize_distributed)
