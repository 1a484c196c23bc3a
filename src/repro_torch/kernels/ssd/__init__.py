from .ops import ssd, ssd_chunked, ssd_decode
from .kernel import ssd_chunk_cuda
from .ref import segsum, ssd_chunk_ref, ssd_decode_ref, ssd_ref

__all__ = ["segsum", "ssd", "ssd_chunk_cuda", "ssd_chunk_ref", "ssd_chunked",
           "ssd_decode", "ssd_decode_ref", "ssd_ref"]
