from tpuvc_torch.coder.rans import decode_batch, decode_with_indexes, encode_with_indexes

__all__ = ["encode_with_indexes", "decode_with_indexes", "decode_batch"]
