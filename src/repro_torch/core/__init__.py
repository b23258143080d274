"""The port's core: quantizers, the dense, compact and packed codecs, and
the pipeline API (counterparts of `repro.core`'s modules of the same names).

The public names are those of `repro.core.__all__`; float64 data takes the
dense and compact codecs but not the packed wire (ROADMAP C-port-2: those
entry points raise for it).
"""
from .audit import (AuditReport, WireIntegrityError, attach_checksum,
                    audit_report, get_policy, register_policy, verify_wire,
                    wire_checksum)
from .bitops import bits_to_float, float_to_bits, log2approx, pow2approx
from .codec import (ENT_MAX_LEN, ENT_SYMS, LC_CHUNK, LC_STAGES,
                    EncodedCompact, EncodedDense, EncodedLC, EncodedPacked,
                    decode_compact, decode_dense, decode_lossless,
                    decode_packed, decode_words_ent, decode_words_lc,
                    encode_compact, encode_dense, encode_lossless,
                    encode_packed, encode_words_ent, encode_words_lc,
                    ent_header_words, lc_chunk_count, lc_header_words,
                    pack_flags, pack_words, packed_word_count,
                    roundtrip_dense, shuffle_word_count, shuffle_words,
                    unpack_flags, unpack_words, unshuffle_words)
from .config import QuantizerConfig
from .pipeline import (GRAMMAR, STAGES, Encoded, Pipeline, parse_pipeline,
                       register_stage)
from .predict import (PRED_STAGES, DeltaStage, KVDeltaStage, LorenzoStage,
                      parse_pred_stages, register_pred_stage)
from .quantizer import (Quantized, dequantize_abs, dequantize_rel, quantize,
                        quantize_abs, quantize_abs_unprotected, quantize_noa,
                        quantize_rel, quantize_rel_library)
from .serializer import compression_ratio, deserialize, serialize
from .transport import TRANSPORT, Transport

__all__ = [
    "QuantizerConfig", "Quantized", "quantize", "quantize_abs", "quantize_rel",
    "quantize_noa", "quantize_abs_unprotected", "quantize_rel_library",
    "dequantize_abs", "dequantize_rel", "encode_dense", "decode_dense",
    "encode_compact", "decode_compact", "encode_packed", "decode_packed",
    "pack_words", "unpack_words", "pack_flags", "unpack_flags",
    "packed_word_count", "roundtrip_dense", "EncodedDense",
    "EncodedCompact", "EncodedPacked", "EncodedLC", "encode_lossless",
    "decode_lossless", "encode_words_lc", "decode_words_lc",
    "lc_chunk_count", "lc_header_words", "LC_CHUNK", "LC_STAGES",
    "encode_words_ent", "decode_words_ent", "ent_header_words",
    "ENT_MAX_LEN", "ENT_SYMS",
    "shuffle_words", "unshuffle_words", "shuffle_word_count",
    "Pipeline", "parse_pipeline", "Encoded", "STAGES", "register_stage",
    "GRAMMAR", "PRED_STAGES", "register_pred_stage", "parse_pred_stages",
    "DeltaStage", "LorenzoStage", "KVDeltaStage",
    "Transport", "TRANSPORT",
    "AuditReport", "WireIntegrityError", "audit_report", "wire_checksum",
    "attach_checksum", "verify_wire", "register_policy", "get_policy",
    "serialize", "deserialize", "compression_ratio",
    "log2approx", "pow2approx", "float_to_bits", "bits_to_float",
]
