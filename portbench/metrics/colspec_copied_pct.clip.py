"""colspec_copied_pct.clip: the share, in %, of kernel 2's calls whose
launch 3 (after the IIR tap scan) brought the rotated spectra into its
strip by asynchronous copies: the change of the counter
`colspec_chunk.copied` (`spectral/fused.py`, what kernel 2's C entry
reports a call) over the change of `colspec_chunk.launches`, both noted
when this reader is loaded, as `colspec_staged_pct.clip` notes its
counters: the calls counted are set-up's and the window's.  None where
kernel 2 made no call (the CPU's plain versions) or the program has no
such counter.  Layer: column spectrum.  Moves frames_per_s."""

from typing import Optional, Tuple


def _counters() -> Optional[Tuple[int, int]]:
    """(copied, launches) of kernel 2's wrapper, or None."""
    try:
        from pbmm_tpu_torch.spectral import fused
    except ImportError:
        return None
    fn = fused.colspec_chunk
    if not all(hasattr(fn, a) for a in ("copied", "launches")):
        return None
    return fn.copied, fn.launches


_ARMED = _counters()


def read(run):
    now = _counters()
    if now is None or _ARMED is None:
        return None
    calls = now[1] - _ARMED[1]
    if calls <= 0:
        return None
    return 100.0 * (now[0] - _ARMED[0]) / calls
