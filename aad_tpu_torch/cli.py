"""Command-line interface: the six reference modes on the card.

Mirrors the reference CLI byte-for-byte (reference: src/main.c,
src/command_line_parser.c): encode -e, decode -d, reconstruct -r, gap -g,
calculate -c, information -i; options -b/--bits-per-sample (default 4),
-s/--max-block-size (default 1024), -t/--num-encode-trials (default 2),
-m/--ms-conversion, -h/--help, -v/--version. Usage text, help listing,
parse diagnostics and the reference's integer-truncation quirks
(uint8/uint16 casts of strtol results, reference: src/main.c:578-588) are
reproduced exactly, as ``aad_tpu.cli`` reproduces them.

The codec runs on the CUDA card. Environment variables, with ``aad_tpu``'s
names (the argv surface is pinned to the reference's):

* ``AAD_TPU_PLATFORM=cpu`` runs it on the CPU, by the kernels' plain torch
  versions; otherwise the six modes need a card, and fail without one;
* ``AAD_TPU_ENGINE`` is the decode engine, ``auto`` (the default),
  ``fused`` or ``pallas``, or ``native``: the native host engine
  (``aad_tpu_torch.native``) encodes and decodes, on the host, and a failed
  build of it fails the command, it does not fall back. ``auto`` stays on
  the card, where ``aad_tpu``'s ``_use_native`` takes the native engine;
* ``AAD_TPU_STRICT=0`` decodes what a truncated stream holds (-d).

Usage: python -m aad_tpu_torch.cli [options] INPUT [OUTPUT]
"""

from __future__ import annotations

import dataclasses
import math
import os
import sys

import numpy as np
import torch

from . import native as native_engine
from .cliparse import OptionSpec, parse_arguments, print_description, strtol10
from .codec.decoder import ENGINES, decode
from .codec.encoder import EncodeConfig, encode
from .codec.result import AadError, InvalidFormatError
from .constants import CH_PROCESS_MS, CH_PROCESS_NONE, CODEC_VERSION, FILE_HEADER_SIZE
from .format.header import decode_header
from .format.wav import WavFormat, WavWriteError, read_wav, write_wav


def _build_specs() -> list[OptionSpec]:
    """The reference's spec table (reference: src/main.c:20-58)."""
    return [
        OptionSpec("e", "encode", False,
                   "Encode mode (wav file -> .aad file)"),
        OptionSpec("d", "decode", False,
                   "Decode mode (.aad file -> wav file)"),
        OptionSpec("r", "reconstruct", False,
                   "Reconstruction mode (wav file -> (encode -> decode) -> "
                   "decoded wav file)"),
        OptionSpec("g", "gap", False,
                   "Gap(residual output) mode (wav file -> (encode -> "
                   "decode) -> residual wav file)"),
        OptionSpec("c", "calculate", False,
                   "Calculate statistics(e.g. RMS error) between original "
                   "and reconstructed wav"),
        OptionSpec("i", "information", False,
                   "Show information of encoded .aad file"),
        OptionSpec("b", "bits-per-sample", True,
                   "Specify bits per sample(in 2,3,4) (default: 4)", "4"),
        OptionSpec("s", "max-block-size", True,
                   "Specify max block size (default: 1024)", "1024"),
        OptionSpec("t", "num-encode-trials", True,
                   "Specify number of encode Trials (default: 2)", "2"),
        OptionSpec("m", "ms-conversion", False,
                   "Switch to use LR to MS conversion (default: no)"),
        OptionSpec("h", "help", False, "Show help message"),
        OptionSpec("v", "version", False, "Show version information"),
    ]


@dataclasses.dataclass
class _Args:
    """Resolved CLI state handed to the mode handlers."""

    bits_per_sample: int = 4
    max_block_size: int = 1024
    num_encode_trials: int = 2
    ms_conversion: bool = False
    device: str = "cuda"
    engine: str = "auto"
    strict: bool = True
    input: str | None = None
    output: str | None = None


class _CliFailure(Exception):
    """Carries the exact reference diagnostic for main() to emit on stderr."""

    def __init__(self, message: str):
        self.message = message
        super().__init__(message)


def _read_wav_cli(path: str):
    """WAV ingest with the reference CLI's diagnostic contract.

    ``WAV_CreateFromFile`` returns NULL for open *and* parse failures alike,
    and every mode reports that as one message (reference: src/main.c:156-160,
    :359-363, :405-409, :451-455).
    """
    try:
        return read_wav(path)
    except (OSError, AadError):
        raise _CliFailure(f"Failed to open {path}. \n") from None


def _read_wav_16bit(path: str):
    """WAV -> (format, int16-valued (C, N) int32).

    The reference CLI truncates canonical PCM to 16 bits on ingest
    (reference: src/main.c:177).
    """
    fmt, pcm32 = _read_wav_cli(path)
    return fmt, (pcm32 >> 16).astype(np.int32)


def _config(args, fmt: WavFormat) -> EncodeConfig:
    return EncodeConfig(
        num_channels=fmt.num_channels,
        sampling_rate=fmt.sampling_rate,
        bits_per_sample=args.bits_per_sample,
        max_block_size=args.max_block_size,
        ch_process_method=CH_PROCESS_MS if args.ms_conversion else CH_PROCESS_NONE,
        num_encode_trials=args.num_encode_trials,
    )


def _write_wav_16bit(path: str, fmt: WavFormat, pcm16: np.ndarray) -> None:
    out_fmt = WavFormat(
        num_channels=fmt.num_channels,
        sampling_rate=fmt.sampling_rate,
        bits_per_sample=16,
        num_samples=pcm16.shape[1],
    )
    write_wav(path, out_fmt, pcm16.astype(np.int32) << 16)


def _encode(args, pcm, fmt) -> bytes:
    engine = "native" if args.engine == "native" else "auto"
    return encode(pcm, _config(args, fmt), device=args.device, engine=engine)


def _decode(args, data):
    return decode(data, device=args.device, engine=args.engine, strict=args.strict)


def _reconstruct(args, path: str):
    """Round trip; returns (fmt, canonical (<<16-domain) pcm, decoded 16-bit).

    The canonical form is kept for residual/statistics modes — with >16-bit
    inputs the reference subtracts from the untruncated original
    (reference: src/main.c:425-432, 470-475).
    """
    fmt, canonical = _read_wav_cli(path)
    pcm = (canonical >> 16).astype(np.int32)
    data = _encode(args, pcm, fmt)
    _, decoded = _decode(args, data)
    return fmt, canonical, np.asarray(decoded)


def cmd_information(path: str) -> int:
    # Diagnostic staging mirrors the reference info mode: open, short-read,
    # then header decode, each with its own message (reference:
    # src/main.c:238-257).
    try:
        with open(path, "rb") as f:
            data = f.read(FILE_HEADER_SIZE)
    except OSError:
        raise _CliFailure(f"Failed to open {path}. \n") from None
    if len(data) < FILE_HEADER_SIZE:
        raise _CliFailure(f"Failed to read from {path}. \n")
    try:
        h = decode_header(data)
    except AadError as e:
        raise _CliFailure(
            f"Failed to read header. API result: {e.result.value} \n"
        ) from None
    ch_name = {0: "None", 1: "MS-Conversion"}.get(h.ch_process_method, "?")
    # Field layout mirrors the reference info dump (reference: src/main.c:260-269)
    rows = [
        ("Format Version:", h.format_version),
        ("Codec Version:", h.codec_version),
        ("Number of Channels:", h.num_channels),
        ("Number of Samples per Channel:", h.num_samples),
        ("Sampling Rate:", h.sampling_rate),
        ("Bits per Sample:", h.bits_per_sample),
        ("Block size:", h.block_size),
        ("Number of Samples per Block:", h.num_samples_per_block),
        ("Channel Processing:", ch_name),
    ]
    for label, value in rows:
        print(f"{label:<30} {value!s:<9}   ")
    bps = 8.0 * h.block_size * h.sampling_rate / h.num_samples_per_block
    print(f"{'Bits per Second(bps):':<30} {bps:<8.1f} ")
    return 0


def _print_usage(prog: str) -> None:
    print(f"Usage: {prog} [options] INPUT_FILE_NAME OUTPUT_FILE_NAME ")


def main(argv=None) -> int:
    """Reference-exact entry flow (reference: src/main.c:518-626)."""
    argv = list(sys.argv if argv is None else ["aad_tpu_torch", *argv])
    prog = argv[0]

    if len(argv) == 1:
        _print_usage(prog)
        print(f"type `{prog} -h` to display usage. ")
        return 1

    specs = _build_specs()
    by_long = {s.long: s for s in specs}
    others = parse_arguments(specs, argv)
    if others is None:
        return 1

    if by_long["help"].acquired:
        _print_usage(prog)
        print("options: ")
        print_description(specs)
        return 0
    if by_long["version"].acquired:
        print(
            "AAD(Ayashi Adaptive Differential pulse code modulation) "
            f"encoder/decoder Version.{CODEC_VERSION} "
        )
        return 0

    mode_names = ["decode", "encode", "information", "reconstruct", "gap",
                  "calculate"]
    num_modes = sum(by_long[m].acquired for m in mode_names)
    if num_modes == 0:
        sys.stderr.write(f"{prog}: must specify at least one mode. \n")
        return 1
    if num_modes >= 2:
        sys.stderr.write(
            f"{prog}: multiple modes cannot specify simultaneously. \n"
        )
        return 1

    # The argv surface is pinned byte-identical to the reference, so the
    # port's knobs ride env vars: the device, the decode engine, and
    # AAD_TPU_STRICT=0, which opts the -d mode into the reference's
    # decode-what's-there behaviour on truncated payloads (see decode()'s
    # strict parameter). A knob that cannot run fails here, before any file
    # is read; nothing falls back.
    args = _Args(
        device="cpu" if os.environ.get("AAD_TPU_PLATFORM", "").lower() == "cpu" else "cuda",
        engine=os.environ.get("AAD_TPU_ENGINE", "auto"),
        strict=os.environ.get("AAD_TPU_STRICT", "1") != "0",
    )
    if args.engine == "native":
        try:
            native_engine.library()
        except native_engine.NativeBuildError as e:
            sys.stderr.write(f"{prog}: AAD_TPU_ENGINE=native: the native engine did not build: {e} \n")
            return 1
    elif args.engine not in ENGINES:
        sys.stderr.write(f"{prog}: AAD_TPU_ENGINE={args.engine}: expected one of {', '.join((*ENGINES, 'native'))}. \n")
        return 1
    elif args.device == "cuda" and not torch.cuda.is_available():
        sys.stderr.write(f"{prog}: no CUDA device; AAD_TPU_PLATFORM=cpu runs on the CPU. \n")
        return 1
    args.input = others[0] if len(others) > 0 else None
    args.output = others[1] if len(others) > 1 else None
    if args.input is None:
        sys.stderr.write(f"{prog}: input file must be specified. \n")
        return 1

    if any(by_long[m].acquired for m in ("encode", "reconstruct", "gap",
                                         "calculate")):
        # The reference narrows through fixed-width fields here: uint8
        # bits/trials, uint16 block size (reference: src/main.c:578-588).
        args.bits_per_sample = strtol10(by_long["bits-per-sample"].argument) & 0xFF
        args.max_block_size = strtol10(by_long["max-block-size"].argument) & 0xFFFF
        args.num_encode_trials = (
            strtol10(by_long["num-encode-trials"].argument) & 0xFF
        )
        args.ms_conversion = by_long["ms-conversion"].acquired

    try:
        if by_long["information"].acquired:
            return cmd_information(args.input)

        if by_long["calculate"].acquired:
            fmt, canonical, decoded = _reconstruct(args, args.input)
            residual = (
                canonical - (decoded.astype(np.int32) << 16)
            ).astype(np.int32)
            # statistics with the reference's exact formula, including its
            # quirk — pcm1 is the residual in the canonical domain while
            # pcm2 is the *unshifted* decoded value (reference:
            # src/main.c:477-497).
            pcm1 = residual.astype(np.float64) / np.iinfo(np.int32).max
            pcm2 = decoded.astype(np.float64) / np.iinfo(np.int32).max
            diff = pcm1 - pcm2
            n = diff.size
            rmse = math.sqrt(float(np.sum(diff**2)) / n)
            msd = float(np.sum(np.abs(diff))) / n
            maxae = float(np.max(np.abs(diff)))
            print(f"RMSE:{rmse:f} MSD:{msd:f} MaxAE:{maxae:f} ")
            return 0

        if args.output is None:
            sys.stderr.write(f"{prog}: output file must be specified. \n")
            return 1

        if by_long["decode"].acquired:
            try:
                with open(args.input, "rb") as f:
                    data = f.read()
            except OSError:
                raise _CliFailure(
                    f"Failed to open {args.input}. \n"
                ) from None
            # Header parse and body decode report separately with the API
            # result value (reference: src/main.c:93-111). The version pin
            # lives in the body stage, as in the reference (DecodeHeader
            # checks only the signature, src/aad_decoder.c:121-133).
            try:
                decode_header(data)
            except AadError as e:
                raise _CliFailure(
                    f"Failed to read header. API result: {e.result.value} \n"
                ) from None
            try:
                header, pcm = _decode(args, data)
            except AadError as e:
                raise _CliFailure(
                    f"Failed to decode. API result: {e.result.value} \n"
                ) from None
            fmt = WavFormat(
                num_channels=header.num_channels,
                sampling_rate=header.sampling_rate,
                bits_per_sample=16,
                num_samples=header.num_samples,
            )
            write_wav(args.output, fmt, pcm << 16)
            return 0

        if by_long["encode"].acquired:
            fmt, pcm = _read_wav_16bit(args.input)
            data = _encode(args, pcm, fmt)
            try:
                f = open(args.output, "wb")
            except OSError:
                # note: no period, unlike the input-open diagnostic
                # (reference: src/main.c:208)
                raise _CliFailure(
                    f"Failed to open output file {args.output} \n"
                ) from None
            with f:
                f.write(data)
            return 0

        fmt, canonical, decoded = _reconstruct(args, args.input)

        if by_long["reconstruct"].acquired:
            _write_wav_16bit(args.output, fmt, decoded)
            return 0

        # gap: residual in the canonical domain with int32 wraparound,
        # exactly as the reference's in-place int32 subtraction (reference:
        # src/main.c:425-432, 470-475).
        residual = (canonical - (decoded.astype(np.int32) << 16)).astype(np.int32)
        write_wav(args.output, fmt, residual)
        return 0

    except _CliFailure as e:
        sys.stderr.write(e.message)
        return 1
    except AadError as e:
        if isinstance(e, InvalidFormatError):
            # invalid encode parameters (reference: src/main.c:193, 318).
            # Only encode-side errors reach here: the decode/info/WAV paths
            # all convert their failures to _CliFailure above.
            sys.stderr.write(
                "Failed to set encode parameter. Please check encode "
                "parameter. \n"
            )
            return 1
        # post-parameter encode failure (reference: src/main.c:201, :326 —
        # note the reference omits the space after the colon here)
        sys.stderr.write(f"Failed to encode. API result:{e.result.value} \n")
        return 1
    except OSError as e:
        # WAV output opens are the only opens not wrapped site-specifically
        # above; any open-failure class (missing dir, permission,
        # is-a-directory) gets the open diagnostic rather than a traceback.
        # Failures *after* a successful open (ENOSPC mid-write) arrive as
        # WavWriteError and report what actually failed, with the errno text.
        name = e.filename if e.filename is not None else args.output
        if isinstance(e, WavWriteError):
            sys.stderr.write(f"Failed to write {name}: {e.strerror}. \n")
        else:
            sys.stderr.write(f"Failed to open {name}. \n")
        return 1


if __name__ == "__main__":
    sys.exit(main())
