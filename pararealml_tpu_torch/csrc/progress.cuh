// How a trajectory kernel of one state publishes its finished frames, so
// that the host side copies them out while the kernel still runs
// (operator.py materialize_solution): a device word that counts the frames
// in device memory, advanced once a chunk of frames (a power of two) and
// once more at the last step, which a stream of copies waits on
// (cuStreamWaitValue32, greater or equal). A null word publishes nothing.

#pragma once

namespace frame_progress {

// Called by one thread of the state's first block after the barrier that
// ends step `step`, which orders every thread's frame stores of the steps
// up to it (on a cluster, every block's) before this thread's next
// instructions. On the last step of a chunk of chunk_mask + 1 frames and on
// the last step, stores step + 1 to `word` behind a system-scope fence:
// each frame store that this thread has observed is performed before the
// word changes, for the stream wait and the copies behind it too.
__device__ __forceinline__ void publish_frames(int* word, int chunk_mask,
                                               int step, int n_steps) {
  const int done = step + 1;
  if ((done & chunk_mask) != 0 && done != n_steps) return;
  __threadfence_system();
  *reinterpret_cast<volatile int*>(word) = done;
}

// Whether a launch may publish to `word` in chunks of `chunk` frames: a
// null word always; a word only for a trajectory of one state, in chunks
// of a power of two.
inline bool publication_valid(const int* word, int chunk, int batch,
                              int write_trajectory) {
  if (word == nullptr) return true;
  return write_trajectory && batch == 1 && chunk > 0 &&
         (chunk & (chunk - 1)) == 0;
}

}  // namespace frame_progress
