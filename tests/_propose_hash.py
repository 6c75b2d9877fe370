"""The proposal hash worked backwards, for tests of ``slack_propose``
(imports neither jax nor torch). Not a test module itself."""

M32 = 0xFFFFFFFF
H1, H2, H3 = 2654435761, 2246822519, 3266489917


def unmix(h: int) -> int:
    """Inverse of the proposal hash's finalizer (``_mix``): each of its
    steps (xor of a right shift, product by an odd constant) is a
    bijection of uint32."""
    def unshift(x, s):
        y = x
        for _ in range(32 // s + 1):
            y = x ^ (y >> s)
        return y & M32
    h = unshift(h, 16)
    h = (h * pow(H3, -1, 2**32)) & M32
    h = unshift(h, 13)
    h = (h * pow(H2, -1, 2**32)) & M32
    return unshift(h, 15)


def umax_salt(i: int, j: int) -> int:
    """The int32 salt under which (row i, column j) hashes to 0xFFFFFFFF:
    the key of (i, j, s) is mix(i*H1 + j*H2 + s*H3) mod 2**32."""
    s = ((unmix(M32) - i * H1 - j * H2) * pow(H3, -1, 2**32)) & M32
    return s - 2**32 if s >= 2**31 else s
