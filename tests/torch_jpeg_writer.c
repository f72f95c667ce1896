/* A small libjpeg helper for the JPEG tests and fixtures, loaded with ctypes.

   gcc -O2 -shared -fPIC -o libtorch_jpeg_writer.so tests/torch_jpeg_writer.c \
       -ljpeg

   tjw_write encodes uint8 pixels with the options PIL does not reach:
   arithmetic coding (SOF9 / SOF10 with the DAC conditioning asked for), any
   sampling factors, a restart interval in MCUs or MCU rows, and a scan
   script (cinfo.scan_info) of the caller's, such as a progression that
   stops refining early. tjw_read_coefficients returns libjpeg's quantised
   coefficients (jpeg_read_coefficients), tjw_read_pixels its default
   decompression (jpeg_read_scanlines: grey or RGB). Every call returns 0,
   or -1 with libjpeg's own message in `msg` (at least JMSG_LENGTH_MAX
   bytes). */

#include <setjmp.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <jpeglib.h>

struct guard {
  struct jpeg_error_mgr pub;
  jmp_buf jump;
  char* msg;
};

static void on_error(j_common_ptr cinfo) {
  struct guard* g = (struct guard*)cinfo->err;
  (*cinfo->err->format_message)(cinfo, g->msg);
  longjmp(g->jump, 1);
}

static void quiet(j_common_ptr cinfo, int level) {
  (void)cinfo;
  (void)level;
}

/* pixels: height x width x ncomp (1 grey, 3 RGB); sampling: h, v per
   component; dac: 16 DC L, 16 DC U, 16 AC Kx, or NULL for libjpeg's
   defaults; scans: nscans x 9 ints (comps in scan, 4 component indices, Ss,
   Se, Ah, Al), or NULL (progressive: jpeg_simple_progression). */
int tjw_write(const unsigned char* pixels, int width, int height, int ncomp,
              int quality, const int* sampling, int arith, int progressive,
              int restart_interval, int restart_rows, const int* dac,
              const int* scans, int nscans, int optimize, unsigned char* out,
              long cap, long* size, char* msg) {
  struct jpeg_compress_struct cinfo;
  struct guard err;
  unsigned char* buf = NULL;
  unsigned long len = 0;
  jpeg_scan_info* script = NULL;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = on_error;
  err.pub.emit_message = quiet;
  err.msg = msg;
  if (setjmp(err.jump)) {
    jpeg_destroy_compress(&cinfo);
    free(buf);
    free(script);
    return -1;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, &buf, &len);
  cinfo.image_width = width;
  cinfo.image_height = height;
  cinfo.input_components = ncomp;
  cinfo.in_color_space = ncomp == 1 ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  for (int c = 0; c < ncomp; ++c) {
    cinfo.comp_info[c].h_samp_factor = sampling[2 * c];
    cinfo.comp_info[c].v_samp_factor = sampling[2 * c + 1];
  }
  cinfo.arith_code = arith ? TRUE : FALSE;
  cinfo.optimize_coding = optimize && !arith ? TRUE : FALSE;
  cinfo.restart_interval = restart_interval;
  cinfo.restart_in_rows = restart_rows;
  if (dac)
    for (int t = 0; t < NUM_ARITH_TBLS; ++t) {
      cinfo.arith_dc_L[t] = (UINT8)dac[t];
      cinfo.arith_dc_U[t] = (UINT8)dac[16 + t];
      cinfo.arith_ac_K[t] = (UINT8)dac[32 + t];
    }
  if (scans) {
    script = (jpeg_scan_info*)calloc(nscans, sizeof(jpeg_scan_info));
    for (int s = 0; s < nscans; ++s) {
      const int* p = scans + 9 * s;
      script[s].comps_in_scan = p[0];
      for (int i = 0; i < 4; ++i) script[s].component_index[i] = p[1 + i];
      script[s].Ss = p[5];
      script[s].Se = p[6];
      script[s].Ah = p[7];
      script[s].Al = p[8];
    }
    cinfo.scan_info = script;
    cinfo.num_scans = nscans;
  } else if (progressive) {
    jpeg_simple_progression(&cinfo);
  }
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = (JSAMPROW)(pixels + (size_t)cinfo.next_scanline * width *
                                           ncomp);
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  free(script);
  *size = (long)len;
  if ((long)len > cap) {
    free(buf);
    snprintf(msg, JMSG_LENGTH_MAX, "output of %lu bytes over the %ld given",
             len, cap);
    return -1;
  }
  memcpy(out, buf, len);
  free(buf);
  return 0;
}

/* Each component's quantised coefficients (natural order) into `out`, at
   offsets[c] blocks, nbx[c] blocks a row, at most nby[c] rows: the blocks
   of libjpeg's virtual array that fall inside that grid. */
int tjw_read_coefficients(const unsigned char* data, long len, short* out,
                          const int* offsets, const int* nbx, const int* nby,
                          char* msg) {
  struct jpeg_decompress_struct cinfo;
  struct guard err;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = on_error;
  err.pub.emit_message = quiet;
  err.msg = msg;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, (unsigned long)len);
  jpeg_read_header(&cinfo, TRUE);
  jvirt_barray_ptr* arrays = jpeg_read_coefficients(&cinfo);
  for (int c = 0; c < cinfo.num_components; ++c) {
    jpeg_component_info* comp = &cinfo.comp_info[c];
    int rows = (int)comp->height_in_blocks, cols = (int)comp->width_in_blocks;
    rows += (comp->v_samp_factor - rows % comp->v_samp_factor) %
            comp->v_samp_factor;
    cols += (comp->h_samp_factor - cols % comp->h_samp_factor) %
            comp->h_samp_factor;
    for (int by = 0; by < rows && by < nby[c]; ++by) {
      JBLOCKARRAY row = (*cinfo.mem->access_virt_barray)(
          (j_common_ptr)&cinfo, arrays[c], by, 1, FALSE);
      for (int bx = 0; bx < cols && bx < nbx[c]; ++bx)
        memcpy(out + ((size_t)offsets[c] + (size_t)by * nbx[c] + bx) * 64,
               row[0][bx], 64 * sizeof(short));
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

/* libjpeg's default decompression (grey for one component, else RGB) into
   `out` (height x width x channels, at most cap bytes); the shape in
   shape[0..2]. */
int tjw_read_pixels(const unsigned char* data, long len, unsigned char* out,
                    long cap, int* shape, char* msg) {
  struct jpeg_decompress_struct cinfo;
  struct guard err;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = on_error;
  err.pub.emit_message = quiet;
  err.msg = msg;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, (unsigned long)len);
  jpeg_read_header(&cinfo, TRUE);
  if (cinfo.num_components != 1) cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  const long stride = (long)cinfo.output_width * cinfo.output_components;
  shape[0] = (int)cinfo.output_height;
  shape[1] = (int)cinfo.output_width;
  shape[2] = cinfo.output_components;
  if (stride * (long)cinfo.output_height > cap) {
    snprintf(msg, JMSG_LENGTH_MAX, "%ld bytes of pixels over the %ld given",
             stride * (long)cinfo.output_height, cap);
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + (size_t)cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}
