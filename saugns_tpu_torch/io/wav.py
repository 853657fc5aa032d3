"""16-bit PCM sound file writers: WAV (little-endian), AU (big-endian,
streamable), raw. Port of player/sndfile.c."""
from __future__ import annotations

import struct
import sys

FORMAT_RAW = 0
FORMAT_AU = 1
FORMAT_WAV = 2
FORMAT_NAMES = ('raw', 'AU', 'WAV')

SOUND_BITS = 16
SOUND_BYTES = SOUND_BITS // 8


class SndFile:
    """Writes int16 interleaved audio; patches header length on close
    (player/sndfile.c:125-215)."""

    def __init__(self, fpath, fmt, channels, srate):
        self.is_subfile = fpath is None
        self.format = fmt
        self.channels = channels
        self.samples = 0
        if self.is_subfile:
            self.f = sys.stdout.buffer
        else:
            self.f = open(fpath, 'wb')
        if fmt == FORMAT_AU:
            self._write_au_header(srate)
        elif fmt == FORMAT_WAV:
            self._write_wav_header(srate)

    def _write_au_header(self, srate):
        f = self.f
        f.write(b'.snd')
        f.write(struct.pack('>IIIII', 28, 0xffffffff, 3, srate,
                            self.channels))
        f.write(struct.pack('>I', 0))

    def _write_wav_header(self, srate):
        f = self.f
        f.write(b'RIFF')
        f.write(struct.pack('<I', 36))
        f.write(b'WAVE')
        f.write(b'fmt ')
        f.write(struct.pack('<IHHIIHH', 16, 1, self.channels, srate,
                            self.channels * srate * SOUND_BYTES,
                            self.channels * SOUND_BYTES, SOUND_BITS))
        f.write(b'data')
        f.write(struct.pack('<I', 0))

    def write(self, buf, samples):
        """buf: int16 numpy array of length channels*samples
        (interleaved)."""
        if self.format == FORMAT_AU:
            data = buf[:self.channels * samples].astype('>i2').tobytes()
        else:
            data = buf[:self.channels * samples].astype('<i2').tobytes()
        self.f.write(data)
        self.samples += samples
        return True

    def close(self):
        if not self.is_subfile:
            if self.format == FORMAT_WAV:
                bytes_ = self.channels * self.samples * SOUND_BYTES
                self.f.seek(4)
                self.f.write(struct.pack('<I', (36 + bytes_) & 0xffffffff))
                self.f.seek(32, 1)
                self.f.write(struct.pack('<I', bytes_ & 0xffffffff))
            elif self.format == FORMAT_AU:
                if self.samples < 0xffffffff:
                    self.f.seek(8)
                    self.f.write(struct.pack(
                        '>I', (self.channels * self.samples * SOUND_BYTES)
                        & 0xffffffff))
            self.f.close()
        else:
            self.f.flush()
        return 0
