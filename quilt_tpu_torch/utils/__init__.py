from .log import print_message, set_verbosity
from .bits import pack_bits_32, unpack_bits_32, unpack_words

__all__ = [
    "print_message",
    "set_verbosity",
    "pack_bits_32",
    "unpack_bits_32",
    "unpack_words",
]
