"""Wire-format communication layer (port of ``repro.fl.comm``): pluggable
uplink codecs, per-client error feedback, and the uplink / downlink wire
contract the round engine accounts bytes through."""
from repro_torch.fl.comm.codecs import (CODECS, Codec, Fp16Codec,  # noqa: F401
                                        NoneCodec, QsgdInt8Codec, TopKCodec,
                                        TreeCodec, WirePayload, get_codec,
                                        register_codec, trees_congruent)
from repro_torch.fl.comm.error_feedback import ErrorFeedback  # noqa: F401
from repro_torch.fl.comm.payload import (DOWNLINK_MODES,  # noqa: F401
                                         CommChannel, WireSpec, WireUpdate,
                                         default_wire_parts, tree_add,
                                         tree_sub)
