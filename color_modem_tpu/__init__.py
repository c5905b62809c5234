"""color_modem_tpu — an analog color-television modem framework in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of the reference
library ``kFYatek/color_modem`` (see SURVEY.md; the reference mount was empty
during the survey and build sessions, so parity is discharged against the
frozen in-repo golden oracle in :mod:`color_modem_tpu.golden`, per SURVEY.md
§0.3 / §4.2).

Architecture (SURVEY.md §7.1):

- ``standards/``  frozen per-standard configs (NTSC / PAL / SECAM / NIIR)
- ``dsp/``        config-time FIR design (NumPy) + on-device application (jnp),
                  closed-form subcarrier NCO, colorimetry matrices
- ``modem/``      pure array functions on ``(lines, samples)`` blocks:
                  QAM core, SECAM FM, NIIR reference-line normalization
- ``separate/``   chroma/luma separation variants: notch, 2/3-line comb,
                  PAL delay-line, chroma averaging
- ``frame/``      batched ``(frames, lines, samples)`` pipeline under ``jit``
- ``parallel/``   device mesh builders + halo-exchange collectives
                  (``shard_map`` + ``ppermute`` over a ``lineblk`` ring)
- ``golden/``     frozen NumPy per-scanline oracle (the accuracy reference)
- ``compat/``     reference-style per-line ``modulate``/``demodulate`` OO API
"""

__version__ = "0.1.0"

from color_modem_tpu.standards import (  # noqa: F401
    ALL_STANDARDS,
    NIIR,
    NTSC,
    NTSC443,
    PAL,
    PAL60,
    PAL_M,
    PAL_N,
    SECAM,
)


def make_pipeline(standard: str, samples: int = 720, decoder: str = "notch",
                  raster: bool = False):
    """One-call convenience: ``(encode, decode, roundtrip)`` for a standard.

        import color_modem_tpu as cmt
        encode, decode, roundtrip = cmt.make_pipeline("pal", decoder="delayline")

    For full control build a plan explicitly (modem.plan.make_plan) and use
    frame.pipeline.make_pipeline / parallel.make_sharded_pipeline.
    """
    from color_modem_tpu.frame.pipeline import make_pipeline as _mk
    from color_modem_tpu.modem.plan import make_plan

    plan = make_plan(ALL_STANDARDS[standard](), samples)
    return _mk(plan, decoder, raster=raster)


def make_interlaced_pipeline(standard: str, samples: int = 720,
                             decoder: str = "notch"):
    """Like :func:`make_pipeline`, transmitting 2:1 interlaced fields
    (frame.interlace): RGB frames <-> field-sequential composite."""
    from color_modem_tpu.frame.interlace import make_interlaced_pipeline as _mk
    from color_modem_tpu.modem.plan import make_plan

    plan = make_plan(ALL_STANDARDS[standard](), samples)
    return _mk(plan, decoder)


def make_svideo_pipeline(standard: str, samples: int = 720):
    """Like :func:`make_pipeline` over separate Y/C planes (frame.svideo):
    no shared wire, hence no separation stage and no cross-color."""
    from color_modem_tpu.frame.svideo import make_svideo_pipeline as _mk
    from color_modem_tpu.modem.plan import make_plan

    plan = make_plan(ALL_STANDARDS[standard](), samples)
    return _mk(plan)


def make_transcoder(src: str, dst: str, samples: int = 720,
                    decoder: str | None = None):
    """Standards converter by name (frame.transcode):
    ``conv = cmt.make_transcoder("ntsc", "pal"); pal = conv(ntsc_comp)``."""
    from color_modem_tpu.frame.transcode import make_transcoder as _mk
    from color_modem_tpu.modem.plan import make_plan

    return _mk(
        make_plan(ALL_STANDARDS[src](), samples),
        make_plan(ALL_STANDARDS[dst](), samples),
        decoder,
    )
