"""Queue serialization for process-mode loader workers.

Counterpart of ``lddl_tpu/loader/qserde.py``. A batch crosses the
worker -> consumer queue as ONE framed bytes payload built with pickle
protocol 5 and out-of-band buffers: the pickle stream carries only the
object skeleton, and every numpy array body is appended as a raw buffer
frame. The consumer decodes it zero-copy: the arrays are writable views
into one ``bytearray``, so the only consumer-side copy is the frame's
bytes -> bytearray transfer.

The arrays of a decoded batch keep that bytearray alive through their
``base``; a tensor made over them with ``torch.from_numpy`` shares it and
must be copied (``pin_memory``) before an asynchronous copy to the device
reads it, which ``dataloader.prefetch_to_device`` does.

Frame layout (little-endian)::

    u32 part_count
    u64 part_len * part_count      (part 0 = pickle payload, 1.. = buffers)
    part bytes, concatenated
"""

import pickle
import struct


def encode(obj):
    """Object -> one framed bytes payload (pickle-5 out-of-band)."""
    buffers = []
    payload = pickle.dumps(obj, protocol=5, buffer_callback=buffers.append)
    parts = [payload] + [b.raw() for b in buffers]
    header = [struct.pack("<I", len(parts))]
    header += [struct.pack("<Q", p.nbytes if isinstance(p, memoryview)
                           else len(p)) for p in parts]
    return b"".join(header + parts)


def decode(data):
    """Framed bytes -> object, its arrays writable views into one
    backing bytearray (one copy of the frame, none per array)."""
    mv = memoryview(bytearray(data))
    (count,) = struct.unpack_from("<I", mv, 0)
    offset = 4 + 8 * count
    parts = []
    for length in struct.unpack_from("<{}Q".format(count), mv, 4):
        parts.append(mv[offset:offset + length])
        offset += length
    return pickle.loads(parts[0], buffers=parts[1:])
