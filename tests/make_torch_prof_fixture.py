"""Write tests/torch_prof/golden.pt.trace.json.gz: a torch.profiler-style
Chrome trace of one small train step on a card, made by hand, with the
device times that tests/test_torch_obs_profile.py checks
rtseg_tpu_torch/obs/profile.py's parse_trace against.

    python tests/make_torch_prof_fixture.py

The events have the shapes and args torch.profiler's export gives on a
CUDA machine: `user_annotation` ranges (module ranges `module:<path>` and
a span), `cpu_op` events with `Sequence number` and `Fwd thread id`,
`cuda_runtime` and `cuda_driver` launches and `kernel`, `gpu_memcpy` and
`gpu_memset` events joined to them by `correlation`, a
`gpu_user_annotation` container on the GPU track, and `deviceProperties`.
It covers: cuDNN's fprop, dgrad and wgrad kernels (conv, not matmul),
CUTLASS and cuBLAS (nvjet) gemms, K1's and K2's kernels (K2 launched
through the driver API), a backward joined to its forward module by
sequence number on autograd's thread, a backward whose forward is
ambiguous (two modules) and one whose forward is outside the trace, a
kernel with no launch event (a replayed graph), a side stream's copy under
a kernel, a memset, a Triton kernel, an nccl kernel and a name with no
identifier. Its hand-computed totals (microseconds): window 470, busy 410
(the union: the 40 us copy lies under the fprop kernel), idle 60;
categories conv 190, matmul 90, copy 45, elementwise 30, collective 30,
resize_argmax 20, reduce 20, confusion_matrix 10, fusion 10,
unattributed 5; modules at depth 2 backbone/conv1 190, backbone/gemm 90,
head 40 (depth 1: backbone 280, head 40).

Deterministic (sorted keys, gzip mtime 0); rerun only to change it, then
commit.
"""

import gzip
import json
import os

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    'torch_prof')
PATH = os.path.join(HERE, 'golden.pt.trace.json.gz')

CPU, MAIN, AUTOGRAD = 4242, 4242, 4250        # pid, main and autograd tids
GPU, STREAM, SIDE = 0, 7, 20                  # device pid, two streams

# (correlation, name, category, ts, dur, stream)
KERNELS = [
    (1, 'sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_'
        'tilesize128x128x64_warpgroupsize1x1x1_execute_segment_k_off_'
        'kernel__5x_cudnn', 'kernel', 1000, 100, STREAM),
    (11, 'Memcpy HtoD (Pinned -> Device)', 'gpu_memcpy', 1010, 40, SIDE),
    (2, 'void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_relu_'
        'bf16_64x64_32x6_tn_align8>(cutlass_80_tensorop_bf16_s16816gemm_'
        'relu_bf16_64x64_32x6_tn_align8::Params)', 'kernel', 1100, 50,
     STREAM),
    (3, 'void head_argmax_kernel<__nv_bfloat16, 8>(__nv_bfloat16 const*, '
        'float const*, int*, float, HeadArgs)', 'kernel', 1150, 20, STREAM),
    (4, 'confusion_kernel(int const*, int const*, int, long, int, int*)',
     'kernel', 1170, 10, STREAM),
    (5, 'void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, '
        'at::native::MeanOps<float, float, float, float>, unsigned int, '
        'float, 4, 4> >(at::native::ReduceOp<float, at::native::MeanOps<'
        'float, float, float, float>, unsigned int, float, 4, 4>)',
     'kernel', 1180, 20, STREAM),
    (6, 'nvjet_tst_64x8_64x16_4x1_v_bz_TNN', 'kernel', 1200, 40, STREAM),
    (7, 'sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_'
        'tilesize128x64x64_warpgroupsize1x1x1_execute_kernel__5x_cudnn',
     'kernel', 1240, 60, STREAM),
    (8, 'sm90_xmma_wgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_'
        'tilesize64x64x64_kernel__5x_cudnn', 'kernel', 1300, 30, STREAM),
    (9, 'void at::native::vectorized_elementwise_kernel<4, at::native::'
        'BinaryFunctor<float, float, float, at::native::binary_internal::'
        'MulFunctor<float> >, std::array<char*, 3ul> >(int, at::native::'
        'BinaryFunctor<float, float, float, at::native::binary_internal::'
        'MulFunctor<float> >, std::array<char*, 3ul>)', 'kernel', 1330, 10,
     STREAM),
    (10, 'ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage'
         '<4096ul>)', 'kernel', 1400, 30, STREAM),
    (77, 'void at::native::vectorized_elementwise_kernel<4, at::native::'
         'FillFunctor<float>, std::array<char*, 1ul> >(int, at::native::'
         'FillFunctor<float>, std::array<char*, 1ul>)', 'kernel', 1430, 10,
     STREAM),
    (12, 'triton_poi_fused_add_mul_0', 'kernel', 1440, 10, STREAM),
    (13, '%', 'kernel', 1450, 5, STREAM),
    (14, 'Memset (Device)', 'gpu_memset', 1455, 5, STREAM),
    (15, 'void at::native::vectorized_elementwise_kernel<4, at::native::'
         'CUDAFunctor_add<float>, std::array<char*, 3ul> >(int, at::native::'
         'CUDAFunctor_add<float>, std::array<char*, 3ul>)', 'kernel', 1460,
     10, STREAM),
]

# (correlation, name, category, tid, ts): the host side of each launch;
# 77 (a replayed graph's kernel) and 13 have none
LAUNCHES = [
    (1, 'cudaLaunchKernel', 'cuda_runtime', MAIN, 10),
    (11, 'cudaMemcpyAsync', 'cuda_runtime', MAIN, 0.5),
    (2, 'cudaLaunchKernel', 'cuda_runtime', MAIN, 55),
    (3, 'cudaLaunchKernel', 'cuda_runtime', MAIN, 115),
    (4, 'cuLaunchKernel', 'cuda_driver', MAIN, 130),
    (12, 'cuLaunchKernel', 'cuda_driver', MAIN, 140),
    (5, 'cudaLaunchKernel', 'cuda_runtime', MAIN, 172),
    (6, 'cudaLaunchKernel', 'cuda_runtime', AUTOGRAD, 205),
    (7, 'cudaLaunchKernel', 'cuda_runtime', AUTOGRAD, 235),
    (8, 'cudaLaunchKernel', 'cuda_runtime', AUTOGRAD, 245),
    (15, 'cudaLaunchKernel', 'cuda_runtime', AUTOGRAD, 266),
    (9, 'cudaLaunchKernel', 'cuda_runtime', AUTOGRAD, 275),
    (14, 'cudaMemsetAsync', 'cuda_runtime', MAIN, 285),
    (10, 'cudaLaunchKernel', 'cuda_runtime', MAIN, 290),
]

# (name, tid, ts, dur): record_function ranges
RANGES = [
    ('train/dispatch', MAIN, 0, 300),
    ('module:backbone', MAIN, 1, 99),
    ('module:backbone/conv1', MAIN, 5, 40),
    ('module:backbone/gemm', MAIN, 50, 40),
    ('module:head', MAIN, 110, 50),
]

# (name, tid, ts, dur, sequence number, fwd thread id)
OPS = [
    ('aten::conv2d', MAIN, 6, 30, 11, 0),
    ('aten::add', MAIN, 38, 4, 13, 0),
    ('aten::addmm', MAIN, 52, 30, 12, 0),
    ('aten::add', MAIN, 120, 4, 13, 0),
    ('aten::nll_loss2d', MAIN, 170, 10, 20, 0),
    ('autograd::engine::evaluate_function: AddmmBackward0', AUTOGRAD, 200,
     20, 12, 1),
    ('autograd::engine::evaluate_function: ConvolutionBackward0', AUTOGRAD,
     230, 30, 11, 1),
    ('autograd::engine::evaluate_function: AddBackward0', AUTOGRAD, 262, 8,
     13, 1),
    ('autograd::engine::evaluate_function: MulBackward0', AUTOGRAD, 272, 8,
     99, 1),
]


def trace() -> dict:
    ev = [{'ph': 'M', 'name': 'process_name', 'pid': CPU, 'tid': 0,
           'args': {'name': 'python'}},
          {'ph': 'M', 'name': 'process_name', 'pid': GPU, 'tid': 0,
           'args': {'name': 'python'}},
          {'ph': 'M', 'name': 'process_labels', 'pid': GPU, 'tid': 0,
           'args': {'labels': 'GPU 0'}},
          {'ph': 'X', 'cat': 'Trace', 'name': 'PyTorch Profiler (0)',
           'pid': 'Spans', 'tid': 'PyTorch Profiler', 'ts': 0, 'dur': 1500}]
    for name, tid, ts, dur in RANGES:
        ev.append({'ph': 'X', 'cat': 'user_annotation', 'name': name,
                   'pid': CPU, 'tid': tid, 'ts': ts, 'dur': dur,
                   'args': {'External id': len(ev)}})
    ev.append({'ph': 'X', 'cat': 'gpu_user_annotation',
               'name': 'train/dispatch', 'pid': GPU, 'tid': STREAM,
               'ts': 1000, 'dur': 470, 'args': {'External id': 5}})
    for name, tid, ts, dur, seq, fwd in OPS:
        ev.append({'ph': 'X', 'cat': 'cpu_op', 'name': name, 'pid': CPU,
                   'tid': tid, 'ts': ts, 'dur': dur,
                   'args': {'External id': len(ev), 'Sequence number': seq,
                            'Fwd thread id': fwd}})
    for corr, name, cat, tid, ts in LAUNCHES:
        ev.append({'ph': 'X', 'cat': cat, 'name': name, 'pid': CPU,
                   'tid': tid, 'ts': ts, 'dur': 3,
                   'args': {'cbid': 211, 'correlation': corr}})
    for corr, name, cat, ts, dur, stream in KERNELS:
        ev.append({'ph': 'X', 'cat': cat, 'name': name, 'pid': GPU,
                   'tid': stream, 'ts': ts, 'dur': dur,
                   'args': {'device': 0, 'stream': stream,
                            'correlation': corr}})
        ev.append({'ph': 'f', 'id': corr, 'pid': GPU, 'tid': stream,
                   'ts': ts, 'cat': 'ac2g', 'name': 'ac2g', 'bp': 'e'})
    return {'schemaVersion': 1, 'displayTimeUnit': 'ms',
            'deviceProperties': [{'id': 0, 'name': 'NVIDIA H100 80GB HBM3',
                                  'totalGlobalMem': 85029158912,
                                  'computeMajor': 9, 'computeMinor': 0}],
            'traceEvents': ev}


def write(path: str = PATH) -> str:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    data = json.dumps(trace(), sort_keys=True, indent=0).encode()
    with open(path, 'wb') as f:
        with gzip.GzipFile(fileobj=f, mode='wb', mtime=0,
                           filename='') as gz:
            gz.write(data)
    return path


if __name__ == '__main__':
    print(write())
