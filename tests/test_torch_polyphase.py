"""The port's polyphase filterbank against the JAX package's, on the same
numpy input: the exact-order f64 form bitwise, the dense f32 form within
f32 matmul rounding."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odr_audioenc_tpu.mp2 import polyphase as jpoly
from odr_audioenc_tpu_torch.mp2 import polyphase as tpoly

from signals import frames_of, music_like
from torch_cpu import one_torch_thread  # noqa: F401


def _input(seed, S=3):
    fr = frames_of(music_like(S + 1, seed=seed)).astype(np.float64) / 32768.0
    return fr[:-1, :, -480:].copy(), fr[1:].copy()        # hist [S,2,480], frame [S,2,1152]


@pytest.mark.parametrize("seed", [1, 9])
def test_polyphase_exact_bitwise(seed):
    """f64 exact order: every subband sample equal to the last bit (the
    reference's C accumulation order is kept on both sides)."""
    hist, frame = _input(seed)
    sj, hj = jpoly.polyphase_frame(jnp.asarray(hist), jnp.asarray(frame), jnp.float64)
    st, ht = tpoly.polyphase_frame(torch.as_tensor(hist), torch.as_tensor(frame))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))


def test_polyphase_dense_f32_close():
    """f32 dense form: one [1632, 1152] matmul on both sides.  The sums run
    in different orders (BLAS vs XLA), so the tolerance is f32 rounding over
    a K=1632 dot of |x| <= 1 inputs: 2e-5 absolute."""
    hist, frame = _input(4)
    sj, _ = jpoly.polyphase_frame(jnp.asarray(hist, jnp.float32),
                                  jnp.asarray(frame, jnp.float32), jnp.float32)
    st, ht = tpoly.polyphase_frame(torch.as_tensor(hist, dtype=torch.float32),
                                   torch.as_tensor(frame, dtype=torch.float32))
    assert st.dtype == torch.float32 and st.shape == (3, 2, 36, 32)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=2e-5)
    np.testing.assert_array_equal(ht.numpy(), frame[..., -480:].astype(np.float32))
