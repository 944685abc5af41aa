from .qmatmul import plain_qmm, qmm_cuda, quantized_matmul

__all__ = ["quantized_matmul", "plain_qmm", "qmm_cuda"]
