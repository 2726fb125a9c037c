"""Output interface (src/Outputs.h:42-56 equivalent)."""


class Output:
    def __init__(self):
        self.audio_left = 0
        self.audio_right = 0

    def update_audio_levels(self, left, right):
        self.audio_left = int(left)
        self.audio_right = int(right)

    def write_frame(self, buf: bytes) -> bool:
        raise NotImplementedError

    def close(self):
        pass
