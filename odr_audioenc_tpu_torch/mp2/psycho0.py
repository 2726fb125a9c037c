"""Psy model A: ATH + scalefactor fudge (port of odr_audioenc_tpu/mp2/psycho0.py;
libtoolame-dab/psycho_0.c)."""


def psycho_0(sf_index, ath_min):
    """sf_index: [..., 3, 32] scalefactor indices (pre-scfsi).
    ath_min: [..., 32] minimum ATH per subband for the stream's sample rate
    (tables.psy0_ath_min), in the working dtype.
    Returns smr [..., 32]  (psycho_0.c:1287-1307)."""
    minscale = sf_index.amin(dim=-2)
    return 2.0 * (30.0 - minscale.to(ath_min.dtype)) - ath_min
