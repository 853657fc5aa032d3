"""System audio output via ALSA (ctypes libasound), with graceful
fallback to a null device when unavailable. Port of
player/audiodev.c + player/audiodev/linux.c.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import os
import sys


class NullAudioDev:
    def __init__(self, srate):
        self.srate = srate

    def write(self, buf, samples):
        return True

    def close(self):
        pass


class AlsaAudioDev:
    """Interleaved S16 playback on 'default' PCM (audiodev/linux.c)."""

    SND_PCM_STREAM_PLAYBACK = 0
    SND_PCM_FORMAT_S16 = 2
    SND_PCM_ACCESS_RW_INTERLEAVED = 3

    def __init__(self, channels, srate):
        lib = ctypes.util.find_library('asound')
        if not lib:
            raise OSError('libasound not found')
        self.a = ctypes.CDLL(lib)
        self.channels = channels
        name = os.environ.get('AUDIODEV', 'default').encode()
        self.pcm = ctypes.c_void_p()
        if self.a.snd_pcm_open(ctypes.byref(self.pcm), name,
                               self.SND_PCM_STREAM_PLAYBACK, 0) < 0:
            raise OSError('snd_pcm_open failed')
        rate = ctypes.c_uint(srate)
        hwp = ctypes.create_string_buffer(8192)
        a = self.a
        if (a.snd_pcm_hw_params_any(self.pcm, hwp) < 0 or
                a.snd_pcm_hw_params_set_access(
                    self.pcm, hwp, self.SND_PCM_ACCESS_RW_INTERLEAVED) < 0
                or a.snd_pcm_hw_params_set_format(
                    self.pcm, hwp, self.SND_PCM_FORMAT_S16) < 0 or
                a.snd_pcm_hw_params_set_channels(
                    self.pcm, hwp, channels) < 0 or
                a.snd_pcm_hw_params_set_rate_near(
                    self.pcm, hwp, ctypes.byref(rate), None) < 0 or
                a.snd_pcm_hw_params(self.pcm, hwp) < 0):
            a.snd_pcm_close(self.pcm)
            raise OSError('ALSA hw params failed')
        self.srate = rate.value

    def write(self, buf, samples):
        data = buf[:samples * self.channels].tobytes()
        written = self.a.snd_pcm_writei(self.pcm, data, samples)
        if written < 0:
            # underrun recovery (audiodev/linux.c:99-107)
            if self.a.snd_pcm_prepare(self.pcm) < 0:
                return False
            written = self.a.snd_pcm_writei(self.pcm, data, samples)
        return written == samples

    def close(self):
        self.a.snd_pcm_drain(self.pcm)
        self.a.snd_pcm_close(self.pcm)


class OssAudioDev:
    """OSS playback via /dev/dsp ioctls (the reference's fallback
    backend, player/audiodev/oss.c: SETFMT/CHANNELS/SPEED then plain
    writes). OSS_AUDIODEV overrides the device path."""

    # <sys/soundcard.h> public ABI
    SNDCTL_DSP_SETFMT = 0xC0045005
    SNDCTL_DSP_CHANNELS = 0xC0045006
    SNDCTL_DSP_SPEED = 0xC0045002
    AFMT_S16_LE = 0x10

    def __init__(self, channels, srate):
        import fcntl
        import struct
        path = os.environ.get('OSS_AUDIODEV', '/dev/dsp')
        try:
            self.fd = os.open(path, os.O_WRONLY)
        except OSError as e:
            raise OSError('OSS open failed: %s' % e)
        try:
            for req, val in ((self.SNDCTL_DSP_SETFMT, self.AFMT_S16_LE),
                             (self.SNDCTL_DSP_CHANNELS, channels),
                             (self.SNDCTL_DSP_SPEED, srate)):
                buf = struct.pack('i', val)
                res = fcntl.ioctl(self.fd, req, buf)
                got = struct.unpack('i', res)[0]
                if req != self.SNDCTL_DSP_SPEED and got != val:
                    raise OSError('OSS param rejected')
                if req == self.SNDCTL_DSP_SPEED:
                    srate = got
        except OSError:
            os.close(self.fd)
            raise
        self.channels = channels
        self.srate = srate

    def write(self, buf, samples):
        data = buf[:samples * self.channels].tobytes()
        return os.write(self.fd, data) == len(data)

    def close(self):
        os.close(self.fd)


def open_audiodev(channels, srate):
    """Open the best available backend: ALSA, then OSS (the
    reference's runtime fallback order, player/audiodev/linux.c:29-46).

    When no backend opens, fail like the reference's init_Player
    (saugns.c:504-516: error + run aborted, exit 1).  Set
    SAUGNS_TPU_NULL_AUDIO=1 to opt into a muted null device instead
    (useful on headless rigs)."""
    for cls in (AlsaAudioDev, OssAudioDev):
        try:
            return cls(channels, srate)
        except OSError:
            pass
    if os.environ.get('SAUGNS_TPU_NULL_AUDIO') == '1':
        print("warning: audiodev: system audio unavailable, "
              "continuing muted", file=sys.stderr)
        return NullAudioDev(srate)
    print("error: audiodev: couldn't open audio device", file=sys.stderr)
    return None
