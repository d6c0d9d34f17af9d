from .mesh import (AllReduceSum, all_reduce_mean, all_reduce_mean_grad,
                   all_reduce_sum, average_, backend, barrier, close,
                   init_multihost, is_distributed, local_device, main_rank,
                   process_count, process_index)

__all__ = ['AllReduceSum', 'all_reduce_mean', 'all_reduce_mean_grad',
           'all_reduce_sum', 'average_', 'backend', 'barrier', 'close',
           'init_multihost', 'is_distributed', 'local_device', 'main_rank',
           'process_count', 'process_index']
