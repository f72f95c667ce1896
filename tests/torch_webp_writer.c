/* A lossy WebP writer over libwebp's encoder, for the options PIL's
 * save() cannot set: the loop filter's type (filter_type 0 simple, 1
 * normal), its strength and sharpness, the token partitions, the segments,
 * and the alpha plane's compression and filtering.
 *
 *   gcc -O2 -o torch_webp_writer tests/torch_webp_writer.c -lwebp
 *   torch_webp_writer in.raw width height channels out.webp [key=value...]
 *
 * in.raw holds width x height pixels of 3 (RGB) or 4 (RGBA) bytes; the
 * keys are WebPConfig's fields of the same name: quality, method,
 * filter_type, filter_strength, filter_sharpness, autofilter, partitions
 * (log2 of the count), segments, sns_strength, alpha_compression,
 * alpha_filtering, alpha_quality. tests/torch_imageio_fixtures.py builds
 * and runs it when the fixtures are written. */

#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <webp/encode.h>

static int set(WebPConfig* c, const char* kv) {
  const char* eq = strchr(kv, '=');
  if (eq == NULL) return 0;
  const size_t n = (size_t)(eq - kv);
  const char* v = eq + 1;
#define FIELD(name)                                      \
  if (n == strlen(#name) && !strncmp(kv, #name, n)) {    \
    c->name = atoi(v);                                   \
    return 1;                                            \
  }
  if (n == 7 && !strncmp(kv, "quality", 7)) {
    c->quality = (float)atof(v);
    return 1;
  }
  FIELD(method) FIELD(filter_type) FIELD(filter_strength)
  FIELD(filter_sharpness) FIELD(autofilter) FIELD(partitions)
  FIELD(segments) FIELD(sns_strength) FIELD(alpha_compression)
  FIELD(alpha_filtering) FIELD(alpha_quality)
#undef FIELD
  return 0;
}

int main(int argc, char** argv) {
  if (argc < 6) {
    fprintf(stderr, "usage: %s in.raw width height channels out.webp "
                    "[key=value...]\n", argv[0]);
    return 2;
  }
  const int width = atoi(argv[2]), height = atoi(argv[3]);
  const int channels = atoi(argv[4]);
  const size_t size = (size_t)width * height * channels;
  unsigned char* px = malloc(size);
  FILE* in = fopen(argv[1], "rb");
  if (px == NULL || in == NULL || fread(px, 1, size, in) != size) {
    fprintf(stderr, "cannot read %zu bytes from %s\n", size, argv[1]);
    return 1;
  }
  fclose(in);
  WebPConfig config;
  WebPPicture pic;
  WebPMemoryWriter writer;
  if (!WebPConfigInit(&config) || !WebPPictureInit(&pic)) return 1;
  for (int i = 6; i < argc; ++i) {
    if (!set(&config, argv[i])) {
      fprintf(stderr, "unknown option %s\n", argv[i]);
      return 2;
    }
  }
  if (!WebPValidateConfig(&config)) {
    fprintf(stderr, "invalid configuration\n");
    return 1;
  }
  pic.width = width;
  pic.height = height;
  pic.use_argb = 0;
  const int ok = channels == 4
                     ? WebPPictureImportRGBA(&pic, px, width * 4)
                     : WebPPictureImportRGB(&pic, px, width * 3);
  if (!ok) return 1;
  WebPMemoryWriterInit(&writer);
  pic.writer = WebPMemoryWrite;
  pic.custom_ptr = &writer;
  if (!WebPEncode(&config, &pic)) {
    fprintf(stderr, "encoding failed: %d\n", pic.error_code);
    return 1;
  }
  FILE* out = fopen(argv[5], "wb");
  if (out == NULL || fwrite(writer.mem, 1, writer.size, out) != writer.size)
    return 1;
  fclose(out);
  WebPMemoryWriterClear(&writer);
  WebPPictureFree(&pic);
  free(px);
  return 0;
}
