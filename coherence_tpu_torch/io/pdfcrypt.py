"""PDF standard security handler (PDF 7.6): RC4 and AES, both directions.

The port's copy of ``coherence_tpu.io.pdfcrypt``, whole.

BEYOND THE BUNDLED ASSETS, camlpdf parity: the reference links camlpdf,
which reads AND writes encrypted files (Pdfcrypt/Pdfwrite); io/pdf.py
calls in here when a trailer carries /Encrypt, and the writer calls
`build_encryption` to mint one.  Supports the Standard filter revisions
2-4 (RC4 40-128 bit, AESV2) and 5/6 (AESV3, AES-256 incl. the Algorithm
2.B hardened hash), with the empty user password or a supplied one.

AES is implemented in pure Python (no external crypto dependency —
decryption throughput is bounded by typical content-stream sizes, and
hot rendering never touches this path).
"""

from __future__ import annotations

import hashlib
import os
import struct
from typing import Optional

__all__ = ["StandardSecurityHandler", "build_encryption", "rc4"]


def rc4(key: bytes, data: bytes) -> bytes:
    S = list(range(256))
    j = 0
    kl = len(key)
    for i in range(256):
        j = (j + S[i] + key[i % kl]) & 0xFF
        S[i], S[j] = S[j], S[i]
    out = bytearray(len(data))
    i = j = 0
    for n, c in enumerate(data):
        i = (i + 1) & 0xFF
        j = (j + S[i]) & 0xFF
        S[i], S[j] = S[j], S[i]
        out[n] = c ^ S[(S[i] + S[j]) & 0xFF]
    return bytes(out)


# --- AES (FIPS-197), pure python ---------------------------------------------

_SBOX = bytes.fromhex(
    "637c777bf26b6fc53001672bfed7ab76ca82c97dfa5947f0add4a2af9ca472c0"
    "b7fd9326363ff7cc34a5e5f171d8311504c723c31896059a071280e2eb27b275"
    "09832c1a1b6e5aa0523bd6b329e32f8453d100ed20fcb15b6acbbe394a4c58cf"
    "d0efaafb434d338545f9027f503c9fa851a3408f929d38f5bcb6da2110fff3d2"
    "cd0c13ec5f974417c4a77e3d645d197360814fdc222a908846eeb814de5e0bdb"
    "e0323a0a4906245cc2d3ac629195e479e7c8376d8dd54ea96c56f4ea657aae08"
    "ba78252e1ca6b4c6e8dd741f4bbd8b8a703eb5664803f60e613557b986c11d9e"
    "e1f8981169d98e949b1e87e9ce5528df8ca1890dbfe6426841992d0fb054bb16"
)
_INV_SBOX = bytes(256)
_inv = bytearray(256)
for _i, _v in enumerate(_SBOX):
    _inv[_v] = _i
_INV_SBOX = bytes(_inv)
_RCON = (0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36, 0x6C, 0xD8)


def _xt(a):  # xtime in GF(2^8)
    a <<= 1
    return (a ^ 0x1B) & 0xFF if a & 0x100 else a


_MUL2 = bytes(_xt(i) for i in range(256))
_MUL3 = bytes(_xt(i) ^ i for i in range(256))


def _mul(a, b):
    r = 0
    while b:
        if b & 1:
            r ^= a
        a = _xt(a)
        b >>= 1
    return r


_MUL9 = bytes(_mul(i, 9) for i in range(256))
_MULB = bytes(_mul(i, 11) for i in range(256))
_MULD = bytes(_mul(i, 13) for i in range(256))
_MULE = bytes(_mul(i, 14) for i in range(256))


def _expand_key(key: bytes):
    nk = len(key) // 4
    nr = nk + 6
    w = [list(key[4 * i : 4 * i + 4]) for i in range(nk)]
    for i in range(nk, 4 * (nr + 1)):
        t = list(w[i - 1])
        if i % nk == 0:
            t = [_SBOX[t[1]], _SBOX[t[2]], _SBOX[t[3]], _SBOX[t[0]]]
            t[0] ^= _RCON[i // nk - 1]
        elif nk > 6 and i % nk == 4:
            t = [_SBOX[b] for b in t]
        w.append([w[i - nk][k] ^ t[k] for k in range(4)])
    return w, nr


def _enc_block(w, nr, b: bytes) -> bytes:
    s = [b[i] ^ w[i // 4][i % 4] for i in range(16)]
    for rnd in range(1, nr + 1):
        s = [_SBOX[x] for x in s]
        # ShiftRows (column-major state: byte i -> row i%4, col i//4)
        s = [s[(i + 4 * (i % 4)) % 16] for i in range(16)]
        if rnd < nr:
            t = []
            for c in range(4):
                a0, a1, a2, a3 = s[4 * c : 4 * c + 4]
                t += [
                    _MUL2[a0] ^ _MUL3[a1] ^ a2 ^ a3,
                    a0 ^ _MUL2[a1] ^ _MUL3[a2] ^ a3,
                    a0 ^ a1 ^ _MUL2[a2] ^ _MUL3[a3],
                    _MUL3[a0] ^ a1 ^ a2 ^ _MUL2[a3],
                ]
            s = t
        k = w[4 * rnd : 4 * rnd + 4]
        s = [s[i] ^ k[i // 4][i % 4] for i in range(16)]
    return bytes(s)


def _dec_block(w, nr, b: bytes) -> bytes:
    s = [b[i] ^ w[4 * nr + i // 4][i % 4] for i in range(16)]
    for rnd in range(nr - 1, -1, -1):
        # InvShiftRows
        s = [s[(i - 4 * (i % 4)) % 16] for i in range(16)]
        s = [_INV_SBOX[x] for x in s]
        k = w[4 * rnd : 4 * rnd + 4]
        s = [s[i] ^ k[i // 4][i % 4] for i in range(16)]
        if rnd > 0:
            t = []
            for c in range(4):
                a0, a1, a2, a3 = s[4 * c : 4 * c + 4]
                t += [
                    _MULE[a0] ^ _MULB[a1] ^ _MULD[a2] ^ _MUL9[a3],
                    _MUL9[a0] ^ _MULE[a1] ^ _MULB[a2] ^ _MULD[a3],
                    _MULD[a0] ^ _MUL9[a1] ^ _MULE[a2] ^ _MULB[a3],
                    _MULB[a0] ^ _MULD[a1] ^ _MUL9[a2] ^ _MULE[a3],
                ]
            s = t
    return bytes(s)


def aes_cbc_decrypt(key: bytes, iv: bytes, data: bytes) -> bytes:
    w, nr = _expand_key(key)
    out = bytearray()
    prev = iv
    for o in range(0, len(data) - len(data) % 16, 16):
        blk = data[o : o + 16]
        p = _dec_block(w, nr, blk)
        out += bytes(a ^ b for a, b in zip(p, prev))
        prev = blk
    return bytes(out)


def aes_cbc_encrypt(key: bytes, iv: bytes, data: bytes) -> bytes:
    w, nr = _expand_key(key)
    out = bytearray()
    prev = iv
    for o in range(0, len(data), 16):
        blk = bytes(a ^ b for a, b in zip(data[o : o + 16], prev))
        prev = _enc_block(w, nr, blk)
        out += prev
    return bytes(out)


# --- standard security handler ------------------------------------------------

_PAD = bytes(
    [
        0x28, 0xBF, 0x4E, 0x5E, 0x4E, 0x75, 0x8A, 0x41, 0x64, 0x00, 0x4E, 0x56,
        0xFF, 0xFA, 0x01, 0x08, 0x2E, 0x2E, 0x00, 0xB6, 0xD0, 0x68, 0x3E, 0x80,
        0x2F, 0x0C, 0xA9, 0xFE, 0x64, 0x53, 0x69, 0x7A,
    ]
)


def _hash_2b(password: bytes, salt: bytes, udata: bytes) -> bytes:
    """Algorithm 2.B (PDF 2.0 / R6 hardened hash)."""
    k = hashlib.sha256(password + salt + udata).digest()
    i = 0
    while True:
        k1 = (password + k + udata) * 64
        e = aes_cbc_encrypt(k[:16], k[16:32], k1)
        mod = sum(e[:16]) % 3
        k = (hashlib.sha256, hashlib.sha384, hashlib.sha512)[mod](e).digest()
        i += 1
        if i >= 64 and e[-1] <= i - 32:
            return k[:32]


class StandardSecurityHandler:
    """Derives the file key and decrypts strings/streams per object."""

    def __init__(self, enc: dict, id0: bytes, password: bytes = b""):
        self.v = int(enc.get("V", 0))
        self.r = int(enc.get("R", 2))
        self.length = int(enc.get("Length", 40)) // 8
        o = enc.get("O", b"")
        u = enc.get("U", b"")
        self.p = int(enc.get("P", -1)) & 0xFFFFFFFF
        self.encrypt_metadata = enc.get("EncryptMetadata", True) is not False
        self.stm_aes = self.str_aes = self.v >= 4
        self.stm_identity = self.str_identity = False
        if self.v >= 4:
            # Crypt filters: /CF + /StmF /StrF select the method.
            cf = enc.get("CF", {}) or {}

            def method(fname):
                nm = getattr(fname, "v", None) or (
                    fname if isinstance(fname, str) else "Identity"
                )
                if nm == "Identity":
                    return None
                d = cf.get(nm, {}) or {}
                cfm = d.get("CFM")
                return getattr(cfm, "v", None) or (
                    cfm if isinstance(cfm, str) else "V2"
                )

            stm = method(enc.get("StmF", "Identity"))
            stt = method(enc.get("StrF", "Identity"))
            self.stm_identity = stm is None
            self.str_identity = stt is None
            self.stm_aes = stm in ("AESV2", "AESV3")
            self.str_aes = stt in ("AESV2", "AESV3")
        if self.r <= 4:
            self.key = self._key_r234(password, o, id0)
        else:
            self.key = self._key_r56(password, o, u, enc)

    def _key_r234(self, password: bytes, o: bytes, id0: bytes) -> bytes:
        pw = (password + _PAD)[:32]
        h = hashlib.md5()
        h.update(pw)
        h.update(o[:32])
        h.update(struct.pack("<I", self.p))
        h.update(id0)
        if self.r >= 4 and not self.encrypt_metadata:
            h.update(b"\xff\xff\xff\xff")
        key = h.digest()
        n = self.length if self.r >= 3 else 5
        if self.r >= 3:
            for _ in range(50):
                key = hashlib.md5(key[:n]).digest()
        return key[:n]

    def _key_r56(self, password: bytes, o: bytes, u: bytes, enc: dict) -> bytes:
        pw = password[:127]
        uvs, uks = u[32:40], u[40:48]
        ovs, oks = o[32:40], o[40:48]

        def hsh(data, salt, udata=b""):
            if self.r == 5:
                return hashlib.sha256(data + salt + udata).digest()
            return _hash_2b(data, salt, udata)

        ue = enc.get("UE", b"")
        oe = enc.get("OE", b"")
        # Try the user password first, then the owner password.
        if hsh(pw, uvs) == u[:32]:
            ik = hsh(pw, uks)
            return aes_cbc_decrypt(ik, b"\x00" * 16, ue)[:32]
        if hsh(pw, ovs, u[:48]) == o[:32]:
            ik = hsh(pw, oks, u[:48])
            return aes_cbc_decrypt(ik, b"\x00" * 16, oe)[:32]
        # Wrong password: fall back to the user-key derivation anyway (a
        # garbage key decrypts to garbage rather than crashing the reader).
        ik = hsh(pw, uks)
        return aes_cbc_decrypt(ik, b"\x00" * 16, ue)[:32]

    def _object_key(self, num: int, gen: int, aes: bool) -> bytes:
        if self.v >= 5:
            return self.key
        h = hashlib.md5()
        h.update(self.key)
        h.update(struct.pack("<I", num)[:3])
        h.update(struct.pack("<I", gen)[:2])
        if aes:
            h.update(b"sAlT")
        return h.digest()[: min(len(self.key) + 5, 16)]

    def _decrypt(self, data: bytes, num: int, gen: int, aes: bool) -> bytes:
        key = self._object_key(num, gen, aes)
        if not aes:
            return rc4(key, data)
        if len(data) < 16:
            return b""
        out = aes_cbc_decrypt(key, data[:16], data[16:])
        pad = out[-1] if out else 0
        if 1 <= pad <= 16 and len(out) >= pad:
            out = out[:-pad]
        return out

    def decrypt_stream(self, data: bytes, num: int, gen: int) -> bytes:
        if self.stm_identity:
            return data
        return self._decrypt(data, num, gen, self.stm_aes)

    def decrypt_string(self, data: bytes, num: int, gen: int) -> bytes:
        if self.str_identity:
            return data
        return self._decrypt(data, num, gen, self.str_aes)

    # -- encryption (writer side; PDF 7.6.2 Algorithm 1/1.A) ------------------

    _rand = staticmethod(os.urandom)  # overridable for deterministic tests

    def _encrypt(self, data: bytes, num: int, gen: int, aes: bool) -> bytes:
        key = self._object_key(num, gen, aes)
        if not aes:
            return rc4(key, data)
        pad = 16 - len(data) % 16  # PKCS#5: always 1..16 bytes of padding
        iv = self._rand(16)
        return iv + aes_cbc_encrypt(key, iv, data + bytes([pad]) * pad)

    def encrypt_stream(self, data: bytes, num: int, gen: int) -> bytes:
        if self.stm_identity:
            return data
        return self._encrypt(data, num, gen, self.stm_aes)

    def encrypt_string(self, data: bytes, num: int, gen: int) -> bytes:
        if self.str_identity:
            return data
        return self._encrypt(data, num, gen, self.str_aes)


# --- writer-side key setup (PDF 7.6.3.4 Algorithms 2-5, 7.6.4.4 8-10) --------


def _pad_pw(pw: bytes) -> bytes:
    return (pw + _PAD)[:32]


def _compute_o_r234(owner_pw: bytes, user_pw: bytes, r: int, n: int) -> bytes:
    """Algorithm 3: the /O entry for revisions 2-4."""
    h = hashlib.md5(_pad_pw(owner_pw or user_pw)).digest()
    if r >= 3:
        for _ in range(50):
            h = hashlib.md5(h).digest()
    key = h[:n]
    o = rc4(key, _pad_pw(user_pw))
    if r >= 3:
        for i in range(1, 20):
            o = rc4(bytes(b ^ i for b in key), o)
    return o


def build_encryption(
    id0: bytes,
    user_pw: bytes = b"",
    owner_pw: Optional[bytes] = None,
    revision: int = 4,
    permissions: int = -4,
    encrypt_metadata: bool = True,
    rand=None,
):
    """Mint a standard-security /Encrypt dictionary and the matching handler.

    camlpdf `Pdfwrite` accepts an encryption spec when saving
    (the reference's Makefile:20); this is the writer-side counterpart of
    `StandardSecurityHandler`.  Returns ``(enc_dict, handler)`` where
    ``enc_dict`` values use plain Python types (crypt-filter names as
    ``pdf.Name``) and ``handler`` is ready to `encrypt_string`/
    `encrypt_stream`.  Revisions: 2 (RC4-40), 3 (RC4-128), 4 (AES-128),
    5/6 (AES-256).  ``rand`` overrides os.urandom for deterministic tests.

    The handler is rebuilt FROM the minted dictionary via the normal
    constructor (authenticating with the user password), so a key-setup
    bug cannot silently cancel against the decrypt path.
    """
    from .pdf import Name  # local: pdf.py imports this module lazily too

    rand = rand or os.urandom
    r = int(revision)
    p = int(permissions)
    enc: dict = {"Filter": Name("Standard"), "R": r, "P": p}
    if r in (2, 3):
        n = 5 if r == 2 else 16
        enc["V"] = 1 if r == 2 else 2
        enc["Length"] = n * 8
        o = _compute_o_r234(owner_pw or b"", user_pw, r, n)
        enc["O"] = o
        # Algorithm 2: the file key (inline: needs O and P before U exists).
        h = hashlib.md5()
        h.update(_pad_pw(user_pw))
        h.update(o)
        h.update(struct.pack("<I", p & 0xFFFFFFFF))
        h.update(id0)
        key = h.digest()
        if r >= 3:
            for _ in range(50):
                key = hashlib.md5(key[:n]).digest()
        key = key[:n]
        if r == 2:  # Algorithm 4
            enc["U"] = rc4(key, _PAD)
        else:  # Algorithm 5
            u = rc4(key, hashlib.md5(_PAD + id0).digest())
            for i in range(1, 20):
                u = rc4(bytes(b ^ i for b in key), u)
            enc["U"] = u + b"\x00" * 16
    elif r == 4:
        n = 16
        enc["V"] = 4
        enc["Length"] = 128
        enc["EncryptMetadata"] = bool(encrypt_metadata)
        o = _compute_o_r234(owner_pw or b"", user_pw, 4, n)
        enc["O"] = o
        h = hashlib.md5()
        h.update(_pad_pw(user_pw))
        h.update(o)
        h.update(struct.pack("<I", p & 0xFFFFFFFF))
        h.update(id0)
        if not encrypt_metadata:
            h.update(b"\xff\xff\xff\xff")
        key = h.digest()
        for _ in range(50):
            key = hashlib.md5(key[:n]).digest()
        key = key[:n]
        u = rc4(key, hashlib.md5(_PAD + id0).digest())
        for i in range(1, 20):
            u = rc4(bytes(b ^ i for b in key), u)
        enc["U"] = u + b"\x00" * 16
        enc["CF"] = {
            "StdCF": {"CFM": Name("AESV2"), "AuthEvent": Name("DocOpen"), "Length": 16}
        }
        enc["StmF"] = Name("StdCF")
        enc["StrF"] = Name("StdCF")
    elif r in (5, 6):
        enc["V"] = 5
        enc["Length"] = 256
        enc["EncryptMetadata"] = bool(encrypt_metadata)
        upw = (user_pw or b"")[:127]
        opw = (owner_pw if owner_pw is not None else user_pw or b"")[:127]
        file_key = rand(32)

        def hsh(data, salt, udata=b""):
            if r == 5:
                return hashlib.sha256(data + salt + udata).digest()
            return _hash_2b(data, salt, udata)

        uvs, uks = rand(8), rand(8)
        u = hsh(upw, uvs) + uvs + uks  # Algorithm 8
        enc["U"] = u
        enc["UE"] = aes_cbc_encrypt(hsh(upw, uks), b"\x00" * 16, file_key)
        ovs, oks = rand(8), rand(8)
        enc["O"] = hsh(opw, ovs, u[:48]) + ovs + oks  # Algorithm 9
        enc["OE"] = aes_cbc_encrypt(hsh(opw, oks, u[:48]), b"\x00" * 16, file_key)
        perms = (  # Algorithm 10: AES-ECB of the permissions block
            struct.pack("<I", p & 0xFFFFFFFF)
            + b"\xff\xff\xff\xff"
            + (b"T" if encrypt_metadata else b"F")
            + b"adb"
            + rand(4)
        )
        enc["Perms"] = aes_cbc_encrypt(file_key, b"\x00" * 16, perms)
        enc["CF"] = {
            "StdCF": {"CFM": Name("AESV3"), "AuthEvent": Name("DocOpen"), "Length": 32}
        }
        enc["StmF"] = Name("StdCF")
        enc["StrF"] = Name("StdCF")
    else:
        raise ValueError(f"unsupported standard-security revision {revision}")

    handler = StandardSecurityHandler(enc, id0, user_pw)
    if r in (5, 6):
        # The constructor re-derives the key by authenticating /U + /UE;
        # a mismatch here means the key setup above is broken.
        assert handler.key == file_key, "R5/R6 key setup self-check failed"
    handler._rand = rand
    return enc, handler
