// io_engine — native blockstore data-plane (BlueStore BlockDevice/aio
// role, src/os/bluestore/KernelDevice.cc + aio.cc, reduced to the
// append-only blob file our blockstore uses).
//
// Copied from the reference's ceph_tpu/ops/native/io_engine.cc. The
// Python store drives it through ctypes: append a blob (one write(2)
// with the crc32c computed in the same pass), read+verify a blob
// (pread(2) + crc32c), and group-sync (fdatasync). Checksums share the
// SSE4.2 crc32c in checksum.cc (ceph_crc32c) so the values are identical
// to the host/python path — on-disk state stays portable between the
// native and pure-python engines, and between the port and the
// reference.

#include <cerrno>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" uint32_t ceph_crc32c(uint32_t crc, const uint8_t *buf,
                                uint64_t len);

extern "C" {

// open (create if absent) the append-only data file; returns fd or -errno
int ioeng_open(const char *path) {
  int fd = ::open(path, O_RDWR | O_CREAT | O_APPEND, 0644);
  return fd >= 0 ? fd : -errno;
}

// current size (append position) or -errno
int64_t ioeng_size(int fd) {
  struct stat st;
  if (fstat(fd, &st) != 0) return -errno;
  return (int64_t)st.st_size;
}

// append the blob; returns its file offset (or -errno). *crc_out gets
// crc32c(seed, blob) computed while the buffer is hot.
// CONCURRENCY CONTRACT: the offset is derived from fstat(st_size), so
// concurrent appends to one fd would alias offsets — callers must
// serialize appends (BlockStore holds its append lock); preads need
// no lock.
int64_t ioeng_append(int fd, const uint8_t *buf, uint64_t len,
                     uint32_t seed, uint32_t *crc_out) {
  struct stat st;
  if (fstat(fd, &st) != 0) return -errno;
  int64_t off = (int64_t)st.st_size;
  if (crc_out) *crc_out = ceph_crc32c(seed, buf, len);
  uint64_t done = 0;
  while (done < len) {
    ssize_t n = ::write(fd, buf + done, len - done);
    if (n < 0) {
      if (errno == EINTR) continue;
      return -errno;
    }
    done += (uint64_t)n;
  }
  return off;
}

// pread the blob; returns bytes read (or -errno). *crc_out gets
// crc32c(seed, data) so the caller verifies without a second pass.
int64_t ioeng_read(int fd, uint64_t off, uint8_t *buf, uint64_t len,
                   uint32_t seed, uint32_t *crc_out) {
  uint64_t done = 0;
  while (done < len) {
    ssize_t n = ::pread(fd, buf + done, len - done, (off_t)(off + done));
    if (n < 0) {
      if (errno == EINTR) continue;
      return -errno;
    }
    if (n == 0) break;  // short read at EOF
  done += (uint64_t)n;
  }
  if (crc_out) *crc_out = ceph_crc32c(seed, buf, done);
  return (int64_t)done;
}

// durability barrier for everything appended so far
int ioeng_sync(int fd) { return ::fdatasync(fd) == 0 ? 0 : -errno; }

int ioeng_close(int fd) { return ::close(fd) == 0 ? 0 : -errno; }

}  // extern "C"
